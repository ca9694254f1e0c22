"""Tensor ops of the port.  The kernels of the render and training paths,
each beside its plain PyTorch version:

====  =============================  =========================  =======================
id    wrapper                        plain version              CUDA source
====  =============================  =========================  =======================
K1    vm_lookup.field_fwd            field_fwd_plain            csrc/vm_lookup.cu
K2    vm_lookup.field_bwd            field_bwd_plain            csrc/vm_lookup.cu
K3    vm_lookup.density_fwd          density_fwd_plain          csrc/vm_lookup.cu
K4    pdf.resample_chart             resample_chart_plain       csrc/resample.cu
K4c   pdf.resample_score             resample_score_plain       csrc/resample.cu
K5    merge.sorted_uniform           sorted_uniform_plain       csrc/sorted_uniform.cu
K6    volrend.composite              composite_plain            csrc/composite.cu
K6e   volrend.composite(envmap=)     composite_plain(envmap=)   csrc/composite.cu
K6b   volrend.composite_bwd          composite_bwd_plain        csrc/composite.cu
K7    chart.chart_fwd                chart_fwd_plain            csrc/chart.cu
K7s   chart.chart_sphere_fwd         chart_sphere_fwd_plain     csrc/chart.cu
K8    envmap.envmap_fwd              envmap_fwd_plain           csrc/envmap.cu
K8b   envmap.envmap_bwd              envmap_bwd_plain           csrc/envmap.cu
K9    alphamask.alpha_fwd            alpha_fwd_plain            csrc/alphamask.cu
K10   mm.mixed_mm                    mixed_mm_plain             csrc/mixed_mm.cu
K10   mm.mixed_mm_da                 mixed_mm_da_plain          csrc/mixed_mm.cu
K10   mm.mixed_mm_db                 mixed_mm_db_plain          csrc/mixed_mm.cu
K11   bias.bias_grad                 bias_grad_plain            csrc/bias_grad.cu
K12   cull.coarse_importance         coarse_importance_plain    csrc/cull.cu
K13   cull.select_top_k              select_top_k_plain         csrc/cull.cu
K14   sampler.theta_ids              theta_ids_plain            csrc/theta_sampler.cu
K14f  sampler.theta_batch            theta_batch_plain          csrc/theta_sampler.cu
K15   vm_lookup.sample_plane_nograd  sample_plane_nograd_plain  csrc/vm_lookup.cu
K15   vm_lookup.sample_line_nograd   sample_line_nograd_plain   csrc/vm_lookup.cu
K16   grid_sample.sample_line        sample_line_plain          csrc/grid_sample.cu
K17   cp.cp_fwd                      cp_fwd_plain               csrc/cp_lookup.cu
K17b  cp.cp_bwd                      cp_bwd_plain               csrc/cp_lookup.cu
====  =============================  =========================  =======================

``resample_chart`` is K4 with K7's chart of the merged depths in its
epilogue: the EgoNeRF forward's resampling and fine chart in one launch
(``pdf.resample`` launches K4 without it); given a ``draw`` key (seed,
step) in place of ``u``, its training instantiation draws K5's sorted
uniforms in its prologue, as does K4c's, so a training step launches no
K5 (``sorted_uniform`` stays for callers that pass ``u``).  ``resample_score`` (K4c) is
the empty-space cull's coarse pass: K4 with K12's score of every merged
sample in its epilogue, the coarse weights kept in the kernel; K13 keeps
the highest.  ``resample_weights`` is K4 writing the coarse weights
instead (the cull's oracle scorer takes its depths); K12 itself
(``cull.coarse_importance``) has no caller on the model's paths, so it
stays out of ``Ops``.  ``KERNELS`` is what the models call.  ``PLAIN``
runs the plain versions on any device; it is the reference the kernels
are held against on the card.
K6e is K6 with K8's envmap lookup inside (the envmap form of
``composite``: the table and the view directions in place of the
radiance); the EgoNeRF forward takes it, and the envmap's pretrain phase
and TensorVMSplit's envmap take K8 itself.
K2, K6b and K8b are the backwards of K1, K6 and K8 inside the autograd
Functions ``vm_lookup.field_train``, ``volrend.composite_train`` (which
also gives K6e's table its gradient through K8b) and
``envmap.envmap_train``.  The training losses take training
instantiations: the entropy's alphas are K6's (``with_alpha``) and their
cotangent K6b's (``d_alpha``), and the sparsity loss's density is K3's
with its relu mask (``with_mask``), differentiated by K2 at no appearance
channels inside ``vm_lookup.density_train``.  K10 (``mm``: the forward ``a @ b``; ``mm_da`` and
``mm_db``: its backward's two contractions, all bf16 x bf16 -> float32) runs
inside ``mm.mixed_matmul`` and K11 (``bias_grad``) is the backward of
``bias.bias_add``; only the shader forms that ``EGONERF_MIXED_MM=1`` and
``EGONERF_BIAS_DOT=1`` select take them (``models/shading.py``).  K14f
draws, picks and gathers a theta-importance batch (``data/samplers.py``);
K14 is the row pick alone on given draws, JAX's function.  K15 (one
bf16 table's lookup with no gradient) and K16 (a float32 line stack's
linear sample) have no caller on either package's model paths, so they
stay out of ``Ops`` (``tools/microbench_lookup.py`` times them): they are
the counterparts of JAX's
``sample_plane_packed_nograd``, ``sample_line_packed_nograd`` and
``grid_sample.sample_line``.
K7s is K7 instantiated for ``generic_sphere``'s single sphere (the yin
test forced true): the TensoRF models' chart on that chart under
``interval_th``, where JAX's radius is the gather-free
``normalize_r_lookup``; their other charts are plain torch maps, as in JAX.
TensorVM takes K1, K3 and K2 in their relu-free instantiations (the
``relu=False`` argument of ``field``, ``density``, ``field_bwd`` and of
``vm_lookup.field_train`` / ``density_train``).  TensorCP's field is K17,
the product of three line samples, with K17b its backward inside
``cp.cp_train``; its eval form reads bf16 lines, its training form the
float32 ones, and its density-only form (no appearance) serves the bake
and the sparsity loss.
"""
from typing import Callable, NamedTuple

from .alphamask import alpha_fwd, alpha_fwd_plain
from .bias import bias_grad, bias_grad_plain
from .cp import cp_bwd, cp_bwd_plain, cp_fwd, cp_fwd_plain
from .chart import chart_fwd, chart_fwd_plain, chart_sphere_fwd, chart_sphere_fwd_plain
from .cull import select_top_k, select_top_k_plain
from .envmap import envmap_bwd, envmap_bwd_plain, envmap_fwd, envmap_fwd_plain
from .merge import sorted_uniform, sorted_uniform_plain
from .mm import (mixed_mm, mixed_mm_da, mixed_mm_da_plain, mixed_mm_db, mixed_mm_db_plain,
                 mixed_mm_plain)
from .pdf import (resample_chart, resample_chart_plain, resample_score, resample_score_plain,
                  resample_weights, resample_weights_plain)
from .sampler import theta_batch, theta_batch_plain, theta_ids, theta_ids_plain
from .vm_lookup import (density_fwd, density_fwd_plain, field_bwd, field_bwd_plain,
                        field_fwd, field_fwd_plain)
from .volrend import composite, composite_bwd, composite_bwd_plain, composite_plain


class Ops(NamedTuple):
    field: Callable
    field_bwd: Callable
    density: Callable
    resample_chart: Callable
    sorted_uniform: Callable
    composite: Callable
    composite_bwd: Callable
    chart: Callable
    envmap: Callable
    envmap_bwd: Callable
    alpha: Callable
    mm: Callable
    mm_da: Callable
    mm_db: Callable
    bias_grad: Callable
    resample_weights: Callable
    resample_score: Callable
    select_top_k: Callable
    theta_ids: Callable
    theta_batch: Callable
    cp: Callable
    cp_bwd: Callable
    chart_sphere: Callable


KERNELS = Ops(field_fwd, field_bwd, density_fwd, resample_chart, sorted_uniform, composite,
              composite_bwd, chart_fwd, envmap_fwd, envmap_bwd, alpha_fwd, mixed_mm, mixed_mm_da,
              mixed_mm_db, bias_grad, resample_weights, resample_score, select_top_k,
              theta_ids, theta_batch, cp_fwd, cp_bwd, chart_sphere_fwd)
PLAIN = Ops(field_fwd_plain, field_bwd_plain, density_fwd_plain, resample_chart_plain,
            sorted_uniform_plain, composite_plain, composite_bwd_plain, chart_fwd_plain,
            envmap_fwd_plain, envmap_bwd_plain, alpha_fwd_plain, mixed_mm_plain,
            mixed_mm_da_plain, mixed_mm_db_plain, bias_grad_plain, resample_weights_plain,
            resample_score_plain, select_top_k_plain, theta_ids_plain, theta_batch_plain,
            cp_fwd_plain, cp_bwd_plain, chart_sphere_fwd_plain)
