"""Coordinate systems.  The port carries the yin-yang chart, the spherical
charts it builds on, and the Cartesian chart of the TensoRF family; the
other charts wait (ROADMAP.md §1)."""
from .base import Coordinates
from .cartesian import CartesianCoords
from .yinyang import YinYangSphericalCoords

coordinates_dict = {"xyz": CartesianCoords, "yinyang": YinYangSphericalCoords}


def make_coordinates(name: str, aabb, exp_r=False, N_voxel=None, r0=None, interval_th=False):
    """Construct a chart the way the trainer does (the Cartesian chart
    takes the aabb alone; the trainer sets its resolution)."""
    if name not in coordinates_dict:
        raise NotImplementedError(
            f"chart {name!r} is not ported yet (ROADMAP.md §1); the port "
            f"carries {sorted(coordinates_dict)}")
    if name == "xyz":
        return CartesianCoords(aabb)
    return coordinates_dict[name](aabb, exp_r=exp_r, N_voxel=N_voxel, r0=r0,
                                  interval_th=interval_th)


def coords_from_spec(spec: dict):
    """Rebuild a coordinate system from a checkpoint's ``coords_spec``."""
    coords = make_coordinates(spec["name"], spec["aabb"], exp_r=spec.get("exp_r", False),
                              r0=spec.get("r0"), interval_th=spec.get("interval_th", False))
    resolution = spec.get("resolution")
    if resolution is not None:
        if isinstance(coords, CartesianCoords):
            coords.set_resolution(resolution)
        else:
            coords.set_resolution(resolution, r0=spec.get("r0"))
    return coords
