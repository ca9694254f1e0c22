"""COLMAP text model -> transforms.json converter (counterpart of
``egonerf_tpu/tools/colmap2nerf.py``, the same numpy on the host).

Reads a COLMAP sparse reconstruction in text form and writes the
transforms.json that :class:`~egonerf_torch.data.datasets.OmniBlenderDataset`
and instant-ngp-style loaders read, as the JAX tool does:
  * camera models SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL /
    OPENCV (k1 k2 p1 p2), OPENCV_FISHEYE (k1-k4) and OPENCV_SPHERICAL
    (equirect: unit focals), with their distortion block;
  * per-frame sharpness (variance of the Laplacian), recorded on each frame
    and optionally used to keep only the N sharpest frames
    (``--keep_sharpest``); the frames are read through the port's
    ``data/png.py::read_image`` (PNG by its own decoder, other formats
    through PIL), where JAX reads them with ``imageio``;
  * the pose normalization: instant-ngp axis convention, mean-up-vector
    rotated onto +z (with the guard for an antiparallel up), recentering on
    the center of attention (pairwise closest-ray point, or the pose
    centroid for spherical captures), and 4/avg-distance scaling, which
    refuses a capture whose origins all coincide;
  * ``--skip_early N``.

Frame extraction and the COLMAP run are thin subprocess wrappers that raise
``RuntimeError`` when the binary is missing.

Usage:
    python -m egonerf_torch.tools.colmap2nerf --text sparse/0 \
        --out transforms.json [--images imgdir] [--keep_sharpest N] \
        [--skip_early N] [--aabb_scale N] [--no_center]
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np

from ..data.png import read_image


def qvec2rotmat(q):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat_between(a, b):
    """Rotation taking unit-ish vector a onto b (reference:
    colmap2nerf.py:125-131)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = float(np.linalg.norm(v))
    if c < -1.0 + 1e-8:
        # anti-parallel vectors (upside-down rig): the Rodrigues form below
        # blows up ((1-c)/s^2 with s~0); a 180-degree rotation about any
        # axis orthogonal to `a` is exact (upstream instant-ngp lacks this
        # guard and emits a garbage rotation)
        axis = np.cross(a, [1.0, 0.0, 0.0])
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, [0.0, 1.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return 2.0 * np.outer(axis, axis) - np.eye(3)
    kmat = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s ** 2 + 1e-10))


def closest_point_2_lines(oa, da, ob, db):
    """Point closest to rays o+t*d (t<=0 halved as upstream) and a weight
    that goes to 0 when parallel (reference: colmap2nerf.py:133-146)."""
    da = da / np.linalg.norm(da)
    db = db / np.linalg.norm(db)
    c = np.cross(da, db)
    denom = float(np.linalg.norm(c) ** 2)
    t = ob - oa
    ta = np.linalg.det([t, db, c]) / (denom + 1e-10)
    tb = np.linalg.det([t, da, c]) / (denom + 1e-10)
    ta, tb = min(ta, 0.0), min(tb, 0.0)
    return (oa + ta * da + ob + tb * db) * 0.5, denom


def sharpness(image_path: str):
    """Variance of the Laplacian on the grayscale image (the reference's
    focus measure, without cv2).  Returns None when the image cannot be
    read."""
    try:
        img = np.asarray(read_image(image_path), np.float64)
    except Exception:
        return None
    if img.ndim == 3:
        # cv2's BGR->GRAY weights on an RGB read
        img = img[..., 2] * 0.114 + img[..., 1] * 0.587 + img[..., 0] * 0.299
    lap = (-4.0 * img
           + np.roll(img, 1, 0) + np.roll(img, -1, 0)
           + np.roll(img, 1, 1) + np.roll(img, -1, 1))
    # np.roll wraps where cv2 reflects: the one-pixel border is zeroed
    lap[0, :] = lap[-1, :] = 0.0
    lap[:, 0] = lap[:, -1] = 0.0
    return float(lap.var())


def read_cameras_text(path: str) -> dict:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            toks = line.split()
            cams[int(toks[0])] = {
                "model": toks[1],
                "w": int(toks[2]),
                "h": int(toks[3]),
                "params": [float(t) for t in toks[4:]],
            }
    return cams


def camera_intrinsics(cam: dict) -> dict:
    """COLMAP camera -> the intrinsics block of transforms.json, including
    distortion coefficients (reference: colmap2nerf.py:160-215; fisheye
    param order per COLMAP src/colmap/sensor/models.h)."""
    w, h, p = float(cam["w"]), float(cam["h"]), cam["params"]
    model = cam["model"]
    out = {"w": w, "h": h, "cx": w / 2, "cy": h / 2,
           "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0}
    if model == "OPENCV_SPHERICAL":
        out.update(fl_x=1.0, fl_y=1.0, is_spherical=True)
    elif model == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif model == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif model == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif model == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif model == "OPENCV":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], p1=p[6], p2=p[7])
    elif model == "OPENCV_FISHEYE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5], k3=p[6], k4=p[7], is_fisheye=True)
    else:
        print(f"unknown camera model {model} — using params[0] as focal")
        out.update(fl_x=p[0], fl_y=p[0])
    out["camera_angle_x"] = 2 * np.arctan(w / (2 * out["fl_x"]))
    out["camera_angle_y"] = 2 * np.arctan(h / (2 * out["fl_y"]))
    return out


def read_images_text(path: str) -> list:
    out = []
    with open(path) as f:
        # keep BLANK lines: an image with zero observations gets an EMPTY
        # points2D line, and dropping it would flip the image/points2D
        # alternation for every following entry
        lines = [l for l in f if not l.startswith("#")]
    for meta_line in lines[::2]:  # every other line is 2-D point data
        toks = meta_line.split()
        if not toks:
            continue  # trailing blank line
        out.append({
            "qvec": [float(t) for t in toks[1:5]],
            "tvec": [float(t) for t in toks[5:8]],
            "camera_id": int(toks[8]),
            "name": " ".join(toks[9:]),  # filenames may contain spaces
        })
    return out


def _ngp_c2w(qvec, tvec) -> np.ndarray:
    """COLMAP pose -> instant-ngp camera convention (reference:
    colmap2nerf.py:255-263: R from -qvec, invert, flip cols 1/2, swap
    rows x/y, flip world z)."""
    m = np.eye(4)
    m[:3, :3] = qvec2rotmat(-np.asarray(qvec, np.float64))
    m[:3, 3] = tvec
    c2w = np.linalg.inv(m)
    c2w[0:3, 2] *= -1
    c2w[0:3, 1] *= -1
    c2w = c2w[[1, 0, 2, 3], :]
    c2w[2, :] *= -1
    return c2w


def normalize_poses(frames: list, is_spherical: bool) -> None:
    """Up-vector alignment + center-of-attention recentering + nerf-size
    scaling, in place (reference: colmap2nerf.py:268-311)."""
    up = np.zeros(3)
    for f in frames:
        up += f["transform_matrix"][0:3, 1]
    up = up / np.linalg.norm(up)
    R = np.pad(rotmat_between(up, np.array([0.0, 0.0, 1.0])), [0, 1])
    R[-1, -1] = 1
    for f in frames:
        f["transform_matrix"] = R @ f["transform_matrix"]

    if is_spherical:
        totp = np.mean([f["transform_matrix"][0:3, 3] for f in frames], axis=0)
    else:
        totw, totp = 0.0, np.zeros(3)
        for f in frames:
            mf = f["transform_matrix"][0:3, :]
            for g in frames:
                mg = g["transform_matrix"][0:3, :]
                p, w = closest_point_2_lines(mf[:, 3], mf[:, 2], mg[:, 3], mg[:, 2])
                if w > 0.01:
                    totp += p * w
                    totw += w
        if totw > 0:
            totp /= totw
    for f in frames:
        f["transform_matrix"][0:3, 3] -= totp
    avglen = np.mean([np.linalg.norm(f["transform_matrix"][0:3, 3])
                      for f in frames])
    # degenerate capture: every recentered origin at the attention center
    # gives avglen 0 and upstream silently emits NaN poses — fail loudly
    if not avglen > 0:
        raise ValueError(
            "normalize_poses: all camera origins coincide with the "
            "attention center (avglen=0) — cannot scale this capture")
    for f in frames:
        f["transform_matrix"][0:3, 3] *= 4.0 / avglen


def colmap_to_transforms(text_dir: str, out_path: str, aabb_scale: int = 16,
                         indoor: bool = True, image_dir: str = None,
                         skip_early: int = 0, keep_sharpest: int = 0,
                         center: bool = True) -> dict:
    cams = read_cameras_text(os.path.join(text_dir, "cameras.txt"))
    images = read_images_text(os.path.join(text_dir, "images.txt"))
    cam = next(iter(cams.values()))
    intr = camera_intrinsics(cam)
    is_spherical = bool(intr.pop("is_spherical", False))

    frames = []
    # skip_early drops the first N *registered* frames in images.txt file
    # order (reference: dataLoader/colmap2nerf.py:243-245 counts file
    # lines), THEN the survivors sort by name for stable output order
    for im in sorted(images[skip_early:], key=lambda i: i["name"]):
        frame = {"file_path": (os.path.join(image_dir, im["name"])
                               if image_dir else im["name"]),
                 "transform_matrix": _ngp_c2w(im["qvec"], im["tvec"])}
        if image_dir:
            b = sharpness(frame["file_path"])
            if b is not None:
                frame["sharpness"] = b
        frames.append(frame)
    if keep_sharpest and any("sharpness" in f for f in frames):
        frames = sorted(frames, key=lambda f: -f.get("sharpness", 0.0)
                        )[:keep_sharpest]
        frames.sort(key=lambda f: f["file_path"])
    if center and frames:
        normalize_poses(frames, is_spherical)

    out = dict(intr)
    for f in frames:
        f["transform_matrix"] = np.asarray(f["transform_matrix"]).tolist()
    out.update(aabb_scale=aabb_scale, indoor=indoor, frames=frames)
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {out_path}: {len(frames)} frames")
    return out


def extract_frames(video: str, out_dir: str, fps: float = 2.0) -> None:
    """ffmpeg frame extraction (gated on the binary existing)."""
    if shutil.which("ffmpeg") is None:
        raise RuntimeError("ffmpeg not found on PATH")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run(["ffmpeg", "-i", video, "-vf", f"fps={fps}",
                    os.path.join(out_dir, "%04d.png")], check=True)


def run_colmap(image_dir: str, workspace: str, matcher: str = "exhaustive") -> None:
    """COLMAP sparse reconstruction (gated on the binary existing)."""
    if shutil.which("colmap") is None:
        raise RuntimeError("colmap not found on PATH")
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    subprocess.run(["colmap", "feature_extractor", "--database_path", db,
                    "--image_path", image_dir], check=True)
    subprocess.run(["colmap", f"{matcher}_matcher", "--database_path", db], check=True)
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    subprocess.run(["colmap", "mapper", "--database_path", db,
                    "--image_path", image_dir, "--output_path", sparse], check=True)
    subprocess.run(["colmap", "model_converter", "--input_path",
                    os.path.join(sparse, "0"), "--output_path",
                    os.path.join(sparse, "0"), "--output_type", "TXT"], check=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kw = {}
    text_dir, out_path = None, "transforms.json"
    i = 0
    while i < len(argv):
        if argv[i] == "--text":
            text_dir = argv[i + 1]; i += 2
        elif argv[i] == "--out":
            out_path = argv[i + 1]; i += 2
        elif argv[i] == "--images":
            kw["image_dir"] = argv[i + 1]; i += 2
        elif argv[i] == "--skip_early":
            kw["skip_early"] = int(argv[i + 1]); i += 2
        elif argv[i] == "--keep_sharpest":
            kw["keep_sharpest"] = int(argv[i + 1]); i += 2
        elif argv[i] == "--aabb_scale":
            kw["aabb_scale"] = int(argv[i + 1]); i += 2
        elif argv[i] == "--no_center":
            kw["center"] = False; i += 1
        else:
            raise SystemExit(f"unknown arg {argv[i]}")
    if not text_dir:
        raise SystemExit(__doc__)
    colmap_to_transforms(text_dir, out_path, **kw)


if __name__ == "__main__":
    main()
