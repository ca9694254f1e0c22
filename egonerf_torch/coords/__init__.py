"""Coordinate systems.  The port carries the yin-yang chart and the
spherical charts it builds on; the other charts wait (ROADMAP.md §1)."""
from .base import Coordinates
from .yinyang import YinYangSphericalCoords

coordinates_dict = {"yinyang": YinYangSphericalCoords}


def coords_from_spec(spec: dict):
    """Rebuild a coordinate system from a checkpoint's ``coords_spec``."""
    spec = dict(spec)
    name = spec.pop("name")
    if name not in coordinates_dict:
        raise NotImplementedError(
            f"chart {name!r} is not ported yet (ROADMAP.md §1); the port "
            f"carries {sorted(coordinates_dict)}")
    coords = coordinates_dict[name](
        spec.pop("aabb"), exp_r=spec.get("exp_r", False), r0=spec.get("r0"),
        interval_th=spec.get("interval_th", False))
    resolution = spec.get("resolution")
    if resolution is not None:
        coords.set_resolution(resolution, r0=spec.get("r0"))
    return coords
