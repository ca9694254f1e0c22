"""``egonerf_torch/tools/colmap2nerf.py`` against the JAX tool on COLMAP
text models that the tests write: every camera model, ``skip_early``,
``keep_sharpest`` on PNG frames, ``--no_center``, ``aabb_scale``, the
degenerate capture, the antiparallel up-vector guard, ``main``'s arguments
and the missing-binary errors.  Both run the same float64 numpy in one
process, and the frames decode to the same uint8 pixels, so the
transforms.json files are held equal, floats bit for bit (tolerance 0)."""
import json
import shutil

import numpy as np
import pytest

from egonerf_tpu.tools import colmap2nerf as jax_tool
from egonerf_torch.data.png import write_png
from egonerf_torch.tools import colmap2nerf as port_tool

# tests/test_tools.py's camera models and their parameters
CAMERAS = {
    "SIMPLE_PINHOLE": [100.0, 90.0, 45.0],
    "PINHOLE": [100.0, 110.0, 90.0, 45.0],
    "SIMPLE_RADIAL": [100.0, 90.0, 45.0, 0.01],
    "RADIAL": [100.0, 90.0, 45.0, 0.01, -0.02],
    "OPENCV": [100.0, 110.0, 90.0, 45.0, 0.1, -0.2, 0.001, 0.002],
    "OPENCV_FISHEYE": [100.0, 110.0, 90.0, 45.0, 0.1, -0.2, 0.03, -0.04],
    "OPENCV_SPHERICAL": [],
    # a model outside the table: params[0] as the focal, with JAX's notice
    "THIN_PRISM_FISHEYE": [120.0, 118.0, 90.0, 45.0] + [0.0] * 8,
}


def _write_model(d, model="OPENCV", params=None, n=6, seed=3, names=None):
    """cameras.txt and images.txt of ``n`` random poses (every other line
    an empty points2D line)."""
    d.mkdir(parents=True, exist_ok=True)
    params = CAMERAS[model] if params is None else params
    (d / "cameras.txt").write_text(
        "# Camera list\n1 " + " ".join([model, "180", "90"] + [repr(p) for p in params]) + "\n")
    rng = np.random.default_rng(seed)
    lines = ["# Image list", "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME"]
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3) * 2 + np.array([1.0, -2.0, 3.0])
        name = names[i] if names else f"im_{(i * 7) % n}.png"
        words = " ".join(repr(float(x)) for x in (*q, *t))
        lines.append(f"{i + 1} {words} 1 {name}")
        lines.append("")
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    return str(d)


def _both(tmp_path, text_dir, **kw):
    """(port's transforms, JAX's transforms), each also read back from the
    file it wrote."""
    outs = []
    for name, tool in (("port", port_tool), ("jax", jax_tool)):
        path = str(tmp_path / f"{name}.json")
        ret = tool.colmap_to_transforms(text_dir, path, **kw)
        with open(path) as f:
            outs.append((ret, json.load(f)))
    (port_ret, port_file), (jax_ret, jax_file) = outs
    assert port_file == jax_file
    assert json.dumps(port_ret, sort_keys=True) == json.dumps(jax_ret, sort_keys=True)
    return port_file


@pytest.mark.parametrize("model", sorted(CAMERAS))
def test_camera_models_match_jax(tmp_path, model):
    """Every camera model's intrinsics and distortion block, and the poses
    normalised (the closest-ray centre, or the centroid for the spherical
    camera)."""
    out = _both(tmp_path, _write_model(tmp_path / "m", model))
    assert len(out["frames"]) == 6
    ms = [np.asarray(f["transform_matrix"]) for f in out["frames"]]
    assert np.mean([np.linalg.norm(m[:3, 3]) for m in ms]) == pytest.approx(4.0)
    assert port_tool.camera_intrinsics({"model": model, "w": 180, "h": 90,
                                        "params": CAMERAS[model]}) == \
        jax_tool.camera_intrinsics({"model": model, "w": 180, "h": 90,
                                    "params": CAMERAS[model]})


def _frames(imgdir, n=6):
    """RGB PNG frames written by ``write_png``: frame i is noise blurred i
    times, so sharpness falls with i; one name is not on disk (no
    sharpness)."""
    imgdir.mkdir()
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(24, 32, 3))
    names = []
    for i in range(n):
        px = np.clip(img, 0, 255).astype(np.uint8)
        name = f"frame {i:02d}.png"  # a space in the name, as COLMAP allows
        write_png(str(imgdir / name), px)
        names.append(name)
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1)) / 3.0
    names[2] = "missing.png"
    return names


OPTIONS = {
    "skip_early": dict(skip_early=2),
    "keep_sharpest": dict(keep_sharpest=3),
    "sharpness_only": dict(),
    "no_center": dict(center=False),
    "aabb_scale": dict(aabb_scale=4, indoor=False),
    "all": dict(skip_early=1, keep_sharpest=2, aabb_scale=2),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_options_match_jax(tmp_path, name):
    """``skip_early`` (file order, then sorted by name), the sharpness of
    PNG frames (None for a missing one) and
    ``keep_sharpest``, ``--no_center`` and ``aabb_scale``."""
    kw = dict(OPTIONS[name])
    names = _frames(tmp_path / "imgs")
    text = _write_model(tmp_path / "m", names=names)
    out = _both(tmp_path, text, image_dir=str(tmp_path / "imgs"), **kw)
    with_sharp = [f for f in out["frames"] if "sharpness" in f]
    assert all(f["sharpness"] == port_tool.sharpness(f["file_path"]) for f in with_sharp)
    assert port_tool.sharpness(str(tmp_path / "imgs" / "missing.png")) is None
    if name == "keep_sharpest":
        assert len(out["frames"]) == 3 and len(with_sharp) == 3
    if name == "sharpness_only":
        assert len(with_sharp) == 5


@pytest.mark.parametrize("spherical", [False, True], ids=["closest_point", "centroid"])
def test_degenerate_capture_raises_as_jax(tmp_path, spherical):
    """Every camera at the world origin with one orientation: the rays are
    parallel (no closest point is weighed) or their centroid is the origin,
    so every recentered origin is 0, and both tools refuse with the same
    ``ValueError``."""
    model = "OPENCV_SPHERICAL" if spherical else "PINHOLE"
    d = tmp_path / "m"
    _write_model(d, model)
    (d / "images.txt").write_text("".join(f"{i} 0.5 0.5 0.5 0.5 0 0 0 1 f{i}.png\n\n"
                                          for i in range(1, 5)))
    errs = []
    for tool in (port_tool, jax_tool):
        with pytest.raises(ValueError) as info:
            tool.colmap_to_transforms(str(d), str(tmp_path / "t.json"))
        errs.append(str(info.value))
    assert errs[0] == errs[1] and "avglen=0" in errs[0]


@pytest.mark.parametrize("a", [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.3, -0.2, 0.9],
                               [-2.0, 1e-9, 0.0]])
def test_rotation_between_antiparallel_vectors(a):
    """``rotmat_between(a, -a)`` takes JAX's 180-degree guard (its fallback
    axis where a is along x), and the general form elsewhere: the same
    matrices, each a rotation taking a onto -a, and onto b in general."""
    a = np.asarray(a)
    for b in (-a, np.array([0.0, 0.0, 1.0]), np.array([0.2, 0.9, -0.1])):
        got, want = port_tool.rotmat_between(a, b), jax_tool.rotmat_between(a, b)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got @ (a / np.linalg.norm(a)), b / np.linalg.norm(b),
                                   atol=1e-7)
    np.testing.assert_allclose(np.linalg.det(port_tool.rotmat_between(a, -a)), 1.0)


def test_upside_down_rig_matches_jax(tmp_path):
    """A rig whose mean up-vector points down: the guard's rotation in the
    whole chain, the same transforms."""
    d = tmp_path / "m"
    _write_model(d, "PINHOLE", n=2)
    # two cameras whose up-vector (column 1 of the instant-ngp pose) is -z
    q = (0.5, 0.5, 0.5, -0.5)
    np.testing.assert_array_equal(port_tool._ngp_c2w(q, [0, 0, 1])[0:3, 1], [0, 0, -1])
    (d / "images.txt").write_text("1 0.5 0.5 0.5 -0.5 0 0 1 1 a.png\n\n"
                                  "2 0.5 0.5 0.5 -0.5 0.5 0 1 1 b.png\n\n")
    out = _both(tmp_path, str(d))
    ups = sum(np.asarray(f["transform_matrix"])[0:3, 1] for f in out["frames"])
    np.testing.assert_allclose(ups / np.linalg.norm(ups), [0, 0, 1], atol=1e-12)


def test_main_arguments_match_jax(tmp_path, capsys):
    """``main``'s flags as JAX's: --text, --out, --images, --skip_early,
    --keep_sharpest, --aabb_scale, --no_center; an unknown flag and a
    missing --text exit as JAX's do."""
    names = _frames(tmp_path / "imgs")
    text = _write_model(tmp_path / "m", names=names)
    files = []
    for name, tool in (("port", port_tool), ("jax", jax_tool)):
        out = str(tmp_path / f"{name}.json")
        tool.main(["--text", text, "--out", out, "--images", str(tmp_path / "imgs"),
                   "--skip_early", "1", "--keep_sharpest", "4", "--aabb_scale", "8",
                   "--no_center"])
        with open(out) as f:
            files.append(json.load(f))
    assert files[0] == files[1] and files[0]["aabb_scale"] == 8 and len(files[0]["frames"]) == 4
    exits = []
    for tool in (port_tool, jax_tool):
        with pytest.raises(SystemExit) as info:
            tool.main(["--text", text, "--bogus"])
        exits.append(info.value.code)
    assert exits[0] == exits[1] == "unknown arg --bogus"
    # no --text: each tool exits with its usage (its own docstring)
    with pytest.raises(SystemExit) as info:
        port_tool.main([])
    assert info.value.code == port_tool.__doc__


def test_missing_binaries_raise(tmp_path, monkeypatch):
    """``extract_frames`` and ``run_colmap`` check for ffmpeg and colmap
    first and raise JAX's ``RuntimeError`` without them."""
    for tool in (port_tool, jax_tool):
        monkeypatch.setattr(tool.shutil, "which", lambda name: None)
    for call in (lambda t: t.extract_frames("v.mp4", str(tmp_path / "f")),
                 lambda t: t.run_colmap(str(tmp_path / "i"), str(tmp_path / "w"))):
        errs = []
        for tool in (port_tool, jax_tool):
            with pytest.raises(RuntimeError) as info:
                call(tool)
            errs.append(str(info.value))
        assert errs[0] == errs[1] and "not found on PATH" in errs[0]
    assert port_tool.shutil is shutil
