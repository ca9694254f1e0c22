"""Coordinate systems.  The port carries the yin-yang chart and the
spherical charts it builds on; the other charts wait (ROADMAP.md §1)."""
from .base import Coordinates
from .yinyang import YinYangSphericalCoords

coordinates_dict = {"yinyang": YinYangSphericalCoords}


def make_coordinates(name: str, aabb, exp_r=False, N_voxel=None, r0=None, interval_th=False):
    """Construct a chart the way the trainer does."""
    if name not in coordinates_dict:
        raise NotImplementedError(
            f"chart {name!r} is not ported yet (ROADMAP.md §1); the port "
            f"carries {sorted(coordinates_dict)}")
    return coordinates_dict[name](aabb, exp_r=exp_r, N_voxel=N_voxel, r0=r0,
                                  interval_th=interval_th)


def coords_from_spec(spec: dict):
    """Rebuild a coordinate system from a checkpoint's ``coords_spec``."""
    coords = make_coordinates(spec["name"], spec["aabb"], exp_r=spec.get("exp_r", False),
                              r0=spec.get("r0"), interval_th=spec.get("interval_th", False))
    resolution = spec.get("resolution")
    if resolution is not None:
        coords.set_resolution(resolution, r0=spec.get("r0"))
    return coords
