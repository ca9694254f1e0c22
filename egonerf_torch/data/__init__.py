"""Data helpers of the port.  The dataset loaders wait (ROADMAP.md §1)."""
from .ray_utils import get_ray_directions_360, get_rays
