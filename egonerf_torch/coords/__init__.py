"""Coordinate systems (counterpart of ``egonerf_tpu/coords/__init__.py``):
the nine charts of JAX's registry, built and restored as JAX builds and
restores them."""
from .base import Coordinates
from .cartesian import CartesianCoords
from .spherical import (BalancedSphericalCoords, CylindricalCoords,
                        DirectionalBalancedSphericalCoords, DirectionalSphericalCoords,
                        EulerSphericalCoords, GenericSphericalCoords, SphericalCoords)
from .yinyang import YinYangSphericalCoords

coordinates_dict = {
    "xyz": CartesianCoords,
    "sphere": SphericalCoords,
    "balanced_sphere": BalancedSphericalCoords,
    "directional_sphere": DirectionalSphericalCoords,
    "directional_balanced_sphere": DirectionalBalancedSphericalCoords,
    "cylinder": CylindricalCoords,
    "euler_sphere": EulerSphericalCoords,
    "yinyang": YinYangSphericalCoords,
    "generic_sphere": GenericSphericalCoords,
}

# the charts that take the radial options (and size themselves from N_voxel)
_RADIAL = ("yinyang", "generic_sphere")


def make_coordinates(name: str, aabb, exp_r=False, N_voxel=None, r0=None, interval_th=False):
    """Construct a chart the way the trainer does: only ``yinyang`` and
    ``generic_sphere`` take ``exp_r``, ``N_voxel``, ``r0`` and
    ``interval_th``; the others take the aabb alone, and the trainer sets
    their resolution."""
    cls = coordinates_dict[name]
    if name in _RADIAL:
        return cls(aabb, exp_r=exp_r, N_voxel=N_voxel, r0=r0, interval_th=interval_th)
    return cls(aabb)


def coords_from_spec(spec: dict):
    """Rebuild a chart from a checkpoint's ``coords_spec`` as JAX does: the
    radial charts through their own ``set_resolution``; the others through
    ``Coordinates.set_resolution``, which takes the stored resolution as it
    is (the directional balanced chart's is already halved); then the
    balanced charts' ``ratio``, ``r0`` and ``coeff`` as stored."""
    spec = dict(spec)
    name = spec.pop("name")
    resolution = spec.pop("resolution", None)
    coords = make_coordinates(name, spec.pop("aabb"), exp_r=spec.get("exp_r", False),
                              r0=spec.get("r0"), interval_th=spec.get("interval_th", False))
    if resolution is not None:
        if name in _RADIAL:
            coords.set_resolution(resolution, r0=spec.get("r0"))
        else:
            Coordinates.set_resolution(coords, resolution)
    for key in ("ratio", "r0", "coeff"):
        if key in spec and hasattr(coords, key) and spec[key] is not None:
            setattr(coords, key, spec[key])
    return coords
