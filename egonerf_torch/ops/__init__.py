"""Tensor ops of the port.  The kernels of the render and training paths,
each beside its plain PyTorch version:

====  ==========================  ======================  =======================
id    wrapper                     plain version           CUDA source
====  ==========================  ======================  =======================
K1    vm_lookup.field_fwd         field_fwd_plain         csrc/vm_lookup.cu
K2    vm_lookup.field_bwd         field_bwd_plain         csrc/vm_lookup.cu
K3    vm_lookup.density_fwd       density_fwd_plain       csrc/vm_lookup.cu
K4    pdf.resample                resample_plain          csrc/resample.cu
K5    merge.sorted_uniform        sorted_uniform_plain    csrc/sorted_uniform.cu
K6    volrend.composite           composite_plain         csrc/composite.cu
K6b   volrend.composite_bwd       composite_bwd_plain     csrc/composite.cu
K7    chart.chart_fwd             chart_fwd_plain         csrc/chart.cu
K8    envmap.envmap_fwd           envmap_fwd_plain        csrc/envmap.cu
K8b   envmap.envmap_bwd           envmap_bwd_plain        csrc/envmap.cu
====  ==========================  ======================  =======================

``KERNELS`` is what the model calls.  ``PLAIN`` runs the plain versions on
any device; it is the reference the kernels are held against on the card.
K2, K6b and K8b are the backwards of K1, K6 and K8 inside the autograd
Functions ``vm_lookup.field_train``, ``volrend.composite_train`` and
``envmap.envmap_train``.
"""
from typing import Callable, NamedTuple

from .chart import chart_fwd, chart_fwd_plain
from .envmap import envmap_bwd, envmap_bwd_plain, envmap_fwd, envmap_fwd_plain
from .merge import sorted_uniform, sorted_uniform_plain
from .pdf import resample, resample_plain
from .vm_lookup import (density_fwd, density_fwd_plain, field_bwd, field_bwd_plain,
                        field_fwd, field_fwd_plain)
from .volrend import composite, composite_bwd, composite_bwd_plain, composite_plain


class Ops(NamedTuple):
    field: Callable
    field_bwd: Callable
    density: Callable
    resample: Callable
    sorted_uniform: Callable
    composite: Callable
    composite_bwd: Callable
    chart: Callable
    envmap: Callable
    envmap_bwd: Callable


KERNELS = Ops(field_fwd, field_bwd, density_fwd, resample, sorted_uniform, composite,
              composite_bwd, chart_fwd, envmap_fwd, envmap_bwd)
PLAIN = Ops(field_fwd_plain, field_bwd_plain, density_fwd_plain, resample_plain,
            sorted_uniform_plain, composite_plain, composite_bwd_plain, chart_fwd_plain,
            envmap_fwd_plain, envmap_bwd_plain)
