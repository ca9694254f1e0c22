"""Tensor ops of the port.  The render path's four kernels, each beside
its plain PyTorch version:

====  ==========================  =====================  ==================
id    wrapper                     plain version          CUDA source
====  ==========================  =====================  ==================
K1    vm_lookup.field_fwd         field_fwd_plain        csrc/vm_lookup.cu
K3    vm_lookup.density_fwd       density_fwd_plain      csrc/vm_lookup.cu
K4    pdf.resample                resample_plain         csrc/resample.cu
K6    volrend.composite           composite_plain        csrc/composite.cu
====  ==========================  =====================  ==================

``KERNELS`` is what the model calls.  ``PLAIN`` runs the plain versions on
any device; it is the reference the kernels are held against on the card.
"""
from typing import Callable, NamedTuple

from .pdf import resample, resample_plain
from .vm_lookup import density_fwd, density_fwd_plain, field_fwd, field_fwd_plain
from .volrend import composite, composite_plain


class Ops(NamedTuple):
    field: Callable
    density: Callable
    resample: Callable
    composite: Callable


KERNELS = Ops(field_fwd, density_fwd, resample, composite)
PLAIN = Ops(field_fwd_plain, density_fwd_plain, resample_plain, composite_plain)
