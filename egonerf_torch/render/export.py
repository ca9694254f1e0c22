"""Iso-surface mesh export (counterpart of ``egonerf_tpu/render/export.py``).

The density of a trained model is baked on a Cartesian grid over its aabb
on the card (:func:`density_grid`: the model's chart, then its density-only
lookup), and the ``alpha == level`` surface is extracted on the host by
marching tetrahedra (six tetrahedra a cell, table-free and watertight) and
written as a binary PLY: the same vertices, faces and bytes as JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..coords.yinyang import YinYangSphericalCoords
from ..models.egonerf import _bf16, feature2density

# the 6-tetrahedron decomposition of a unit cell; vertex ids are cube
# corners in (dx, dy, dz) binary order
_CUBE = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
    [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
], dtype=np.float32)
_TETS = np.array([
    [0, 5, 1, 3], [0, 5, 3, 7], [0, 3, 2, 7],
    [0, 2, 6, 7], [0, 6, 4, 7], [0, 4, 5, 7],
], dtype=np.int32)
# the edges of a tetrahedron as pairs of its vertex ids; a sign case is a
# bitmask with bit i set where corner i is inside
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _tet_triangles(case: int):
    """Triangles (triples of edge ids) of one tetrahedron sign case."""
    inside = [i for i in range(4) if case & (1 << i)]
    if len(inside) in (0, 4):
        return []
    cross = [e for e, (a, b) in enumerate(_TET_EDGES)
             if ((case >> a) & 1) != ((case >> b) & 1)]
    if len(cross) == 3:
        return [tuple(cross)]
    # four crossed edges: a quad, as two triangles around its boundary,
    # where two edges that share a vertex are adjacent
    def shares(e1, e2):
        return bool(set(_TET_EDGES[e1]) & set(_TET_EDGES[e2]))

    a, rest = cross[0], cross[1:]
    adj = [e for e in rest if shares(a, e)]
    opp = [e for e in rest if not shares(a, e)][0]
    return [(a, adj[0], opp), (a, opp, adj[1])]


_TET_TRI_TABLE = [_tet_triangles(c) for c in range(16)]


def marching_tetrahedra(volume: np.ndarray, level: float, spacing=(1.0, 1.0, 1.0),
                        origin=(0.0, 0.0, 0.0)):
    """The ``volume == level`` surface of an (X, Y, Z) scalar field: (verts
    (V, 3) float32, faces (F, 3) int32), vertices in ``origin + index *
    spacing`` units."""
    vol = np.asarray(volume, np.float32)
    nx, ny, nz = vol.shape
    cx, cy, cz = np.meshgrid(np.arange(nx - 1, dtype=np.int32),
                             np.arange(ny - 1, dtype=np.int32),
                             np.arange(nz - 1, dtype=np.int32), indexing="ij")
    cells = np.stack([cx, cy, cz], -1).reshape(-1, 3)
    # each cell's eight corner values from eight shifted views of the volume
    vals = np.stack([vol[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                     for dx, dy, dz in _CUBE.astype(int)], -1).reshape(-1, 8)
    crossing = (vals.min(1) < level) & (vals.max(1) >= level)
    cells, vals = cells[crossing], vals[crossing]

    verts, faces, n_verts = [], [], 0
    for tet in _TETS:
        tvals = vals[:, tet]  # (M, 4)
        case = ((tvals >= level) << np.arange(4)).sum(1)
        for c in range(1, 15):
            tris = _TET_TRI_TABLE[c]
            m = case == c
            if not tris or not m.any():
                continue
            sub_cells, sub_vals = cells[m], tvals[m]
            # the surface's crossing on each edge, interpolated
            edge_pos = {}
            for e, (a, b) in enumerate(_TET_EDGES):
                va, vb = sub_vals[:, a], sub_vals[:, b]
                denom = np.where(np.abs(vb - va) < 1e-12, 1.0, vb - va)
                t = np.clip((level - va) / denom, 0.0, 1.0)
                pa = sub_cells + _CUBE[tet[a]]
                pb = sub_cells + _CUBE[tet[b]]
                edge_pos[e] = pa + t[:, None] * (pb - pa)
            for tri in tris:
                n = len(edge_pos[tri[0]])
                verts.extend([edge_pos[tri[0]], edge_pos[tri[1]], edge_pos[tri[2]]])
                faces.append(np.stack([n_verts + np.arange(n), n_verts + n + np.arange(n),
                                       n_verts + 2 * n + np.arange(n)], -1))
                n_verts += 3 * n

    if not verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(verts).astype(np.float32)
    faces = np.concatenate(faces).astype(np.int32)
    verts = verts * np.asarray(spacing, np.float32) + np.asarray(origin, np.float32)
    return verts, faces


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """A binary little-endian PLY of float32 vertices and triangles."""
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_indices\nend_header\n")
        f.write(np.asarray(verts, "<f4").tobytes())
        face_block = np.empty((len(faces), 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = np.asarray(faces, "<i4").view(np.uint8).reshape(len(faces), 12)
        f.write(face_block.tobytes())


@torch.no_grad()
def density_grid(model, params, grid_size: int = 128, chunk_rows: int = 8) -> torch.Tensor:
    """alpha = 1 - exp(-sigma step_size) on a ``grid_size``^3 Cartesian grid
    spanning the model's aabb, (X, Y, Z) on the model's device (JAX's
    ``density_rows``, ``render/export.py:144-156``).  ``chunk_rows`` x
    values a call, as JAX's, so a line's hat gate counts the same points.
    Each call's points are rays: o = (x, y, 0), d = (0, 0, 1) and the z
    axis as depths, so o + d z is the point exactly; EgoNeRF charts them
    with K7 and looks the density up with K3 on the bf16 fine density
    tables; the TensoRF family with its chart (K7s on ``generic_sphere``
    under ``interval_th``) and its density-only lookup (K3 at S = 1, K17's
    density form for TensorCP)."""
    aabb = np.asarray(model.aabb, np.float32)
    gs = [int(grid_size)] * 3
    axes = [np.linspace(aabb[0][d], aabb[1][d], gs[d], dtype=np.float32) for d in range(3)]
    dev = model.device
    ay = torch.as_tensor(axes[1], device=dev)
    az = torch.as_tensor(axes[2], device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    coords = model.coordinates
    if isinstance(coords, YinYangSphericalCoords):
        planes = _bf16(params[f"density_planes.{i}"] for i in range(3))
        lines = _bf16(params[f"density_lines.{i}"] for i in range(3))
    rows = []
    for i in range(0, gs[0], chunk_rows):
        ax = torch.as_tensor(axes[0][i:i + chunk_rows], device=dev)
        x, y = torch.meshgrid(ax, ay, indexing="ij")
        rays_o = torch.stack([x.reshape(-1), y.reshape(-1), torch.zeros_like(x).reshape(-1)], -1)
        rays_d = up.expand(rays_o.shape[0], 3)
        z = az.expand(rays_o.shape[0], gs[2])
        if isinstance(coords, YinYangSphericalCoords):
            norm = model.ops.chart(rays_o, rays_d, z, coords)
            feat = model._density(planes, lines, norm)
        else:
            norm = model.chart_coords(rays_o, rays_d, z)
            feat = model.compute_density_feature_only(params, norm)
        sigma = feature2density(feat, model.cfg)
        rows.append((1.0 - torch.exp(-sigma * model.step_size)).reshape(len(ax), gs[1], gs[2]))
    return torch.cat(rows)


def export_density_mesh(model, params, path: str, grid_size=128, level=0.005, chunk_rows=8):
    """Bake the model's density on a ``grid_size``^3 Cartesian grid over its
    aabb (:func:`density_grid`) and write the ``alpha == level`` surface to
    the PLY at ``path``; returns (verts, faces)."""
    alpha = density_grid(model, params, grid_size, chunk_rows).cpu().numpy()
    aabb = np.asarray(model.aabb, np.float32)
    spacing = (aabb[1] - aabb[0]) / (np.asarray(alpha.shape) - 1)
    verts, faces = marching_tetrahedra(alpha, level, spacing=spacing, origin=aabb[0])
    write_ply(path, verts, faces)
    print(f"exported mesh: {len(verts)} verts, {len(faces)} faces -> {path}")
    return verts, faces
