"""What a per-layer metric's reader (``metrics/<name>.py``, a function
``read(ctx)`` returning a number or None) is given: the run's spans,
counts and traced segment, the shapes of a step or a chunk, and the
families with their costs."""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

from benchlib import costs


class Context:
    def __init__(self, mode: str, result, step_shapes: costs.Shapes, view_rays: int, fams):
        self.mode = mode                  # "train" or "render"
        self.spans = result.spans.s       # seconds by span name
        self.counters = result.counters   # the window's counts
        self.trace = result.trace         # the traced segment, or None
        self.shapes = step_shapes         # a training step's, or a render chunk's
        self.view_rays = view_rays        # rays a view (render)
        self.fams = {f.NAME: f for f in fams}

    def family_ms(self, stem: str) -> Optional[float]:
        """Device ms a traced unit (step or view) of the family ``stem``;
        None where the segment was not traced or the family did not run."""
        if self.trace is None or stem not in self.trace.family_s:
            return None
        return 1e3 * self.trace.family_s[stem] / self.trace.units

    def unit_shapes(self) -> costs.Shapes:
        """The shapes of a whole unit: a step, or a view's rays."""
        if self.mode == "train":
            return self.shapes
        return replace(self.shapes, rays=self.view_rays)

    def gemm_roofline(self) -> Optional[float]:
        """% of the float32 peak that the shader's and basis's needed
        operations reach over the GEMM family's device time."""
        ms = self.family_ms("gemm")
        if not ms:
            return None
        flop = costs.gemm_flop(self.unit_shapes())
        return 100.0 * flop / costs.PEAK_F32_FLOP_PER_S / (ms * 1e-3)

    def kernels_roofline(self) -> Optional[float]:
        """% that the hand kernels' bounds (launches x bound) make of their
        device time.  A hand kernel with no family file of its own falls
        in none of them and is not counted."""
        if self.trace is None:
            return None
        bound = spent = 0.0
        for stem, secs in self.trace.family_s.items():
            fam = self.fams.get(stem)
            if fam is None or not fam.KERNEL:
                continue
            bound += self.trace.family_launches[stem] * costs.bound_s(*fam.cost(self.shapes))
            spent += secs
        return 100.0 * bound / spent if spent else None

    def mfu(self) -> Optional[float]:
        """% of the float32 peak that the model's operations over the
        window make."""
        units = self.counters.get("steps" if self.mode == "train" else "views")
        if not units:
            return None
        flop = costs.model_flop(self.unit_shapes()) * units
        return 100.0 * flop / (self.counters["window_s"] * costs.PEAK_F32_FLOP_PER_S)

    def device_idle(self) -> Optional[float]:
        if self.trace is None:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)
