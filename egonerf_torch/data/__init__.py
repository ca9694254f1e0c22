"""Data of the port: ray generation, the procedural scene and its dataset,
and the device-side ray sampler.  The loaders of captured data wait
(ROADMAP.md §1)."""
from .ray_utils import get_ray_directions_360, get_rays
