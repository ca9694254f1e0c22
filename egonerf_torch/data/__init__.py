"""Data of the port: the loaders of captured data (OmniBlender, the
egocentric video loader with its COLMAP, OpenVSLAM and Pix4D pose readers,
OmniScenes, LLFF) and the procedural scene, their PNG codec, ray
generation, and the ray samplers (uniform, and theta-importance with K14
drawing the rows on the card)."""
from .ray_utils import get_ray_directions_360, get_rays
