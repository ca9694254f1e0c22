"""The upstream-checkpoint bridge (``tools/import_reference_ckpt``,
``tools/export_reference_ckpt``) against the JAX package's, on the CPU.

The tools unpickle and build the upstream PyTorch EgoNeRF's classes, so
the tests write a stand-in upstream checkout once per module: a
``models/`` package with the upstream class names (the nine coordinate
classes, ``EgoNeRF`` and ``YinYangAlphaGridMask``, TensorVMSplit,
TensorVM and TensorCP, ``AlphaGridMask``), the parameter names and shapes
the tools read and write, and a ``save`` that writes the entries the
import reads.  JAX's own export -> import through it is the identity,
which pins it to JAX's mapping; the port is then held to JAX on it in
both directions, bit for bit.  Its fidelity to the real upstream rests on
JAX's reference-gated tests (``tests/test_reference_parity.py``) and on
the gated mirrors at the end of this file, which run where the upstream
checkout is present.

Every import of the stand-in (``models``) and every stub the tools put
into ``sys.modules`` is taken out again after each test, as is the
stand-in's place on ``sys.path``.
"""
import contextlib
import functools
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from egonerf_tpu.tools import export_reference_ckpt as jax_export_mod
from egonerf_tpu.tools import import_reference_ckpt as jax_import_mod
from egonerf_torch.coords import make_coordinates
from egonerf_torch.models import MODELS, load_jax_checkpoint, model_meta
from egonerf_torch.models.alphamask import mask_from_volumes
from egonerf_torch.models.egonerf import FieldConfig
from egonerf_torch.tools import export_reference_ckpt, import_reference_ckpt
from egonerf_torch.tools.reference_layout import REFERENCE, _stub_ref_deps
from egonerf_torch.train.checkpoint import (load_alpha_masks, load_checkpoint, mask_volumes,
                                            save_checkpoint)

torch.set_num_threads(1)

_STUBS = ("torchvision", "torchvision.transforms", "kornia", "cv2", "plyfile", "skimage",
          "skimage.measure")

# the stand-in upstream checkout: models/<file> -> source
STANDIN = {
    "__init__.py": '"""Stand-in of the upstream EgoNeRF ``models`` package."""\n',
    "coordinates.py": '''
        """The upstream chart classes: what the checkpoint bridge builds and
        what a pickled ``kwargs["coordinates"]`` carries."""


        class Coordinates:
            def __init__(self, device, aabb):
                self.device = device
                self.aabb = aabb
                self.resolution = None

            def set_resolution(self, resolution):
                self.resolution = list(resolution)


        class CartesianCoords(Coordinates):
            pass


        class SphericalCoords(Coordinates):
            pass


        class BalancedSphericalCoords(SphericalCoords):
            pass


        class DirectionalSphericalCoords(SphericalCoords):
            pass


        class DirectionalBalancedSphericalCoords(SphericalCoords):
            pass


        class EulerSphericalCoords(SphericalCoords):
            pass


        class CylindricalCoords(Coordinates):
            pass


        class GenericSphericalCoords(Coordinates):
            def __init__(self, device, aabb, exp_r=False, N_voxel=None, r0=None,
                         interval_th=False):
                super().__init__(device, aabb)
                self.exp_r = exp_r
                self.N_voxel = N_voxel
                self.r0 = r0
                self.interval_th = interval_th

            def set_resolution(self, resolution, r0=None):
                self.resolution = list(resolution)
                self.r0 = r0


        class YinYangSphericalCoords(GenericSphericalCoords):
            pass
        ''',
    "tensorBase.py": '''
        """The upstream TensorBase: its render module, envmap, alpha mask,
        kwargs and ``save``."""
        import numpy as np
        import torch
        from torch import nn


        class AlphaGridMask(nn.Module):
            def __init__(self, device, alpha_volume):
                super().__init__()
                # the (1, 1, D, H, W) grid_sample view
                self.alpha_volume = alpha_volume.view(1, 1, *alpha_volume.shape[-3:]).to(device)


        class EnvironmentMap(nn.Module):
            def __init__(self, h):
                super().__init__()
                self.emission = nn.Parameter(torch.zeros(3, 2 * h, h))


        class RenderModule(nn.Module):
            def __init__(self, n_in, featureC):
                super().__init__()
                self.mlp = nn.Sequential(nn.Linear(n_in, featureC), nn.ReLU(inplace=True),
                                         nn.Linear(featureC, featureC), nn.ReLU(inplace=True),
                                         nn.Linear(featureC, 3))


        def render_module(shadingMode, pos_pe, view_pe, fea_pe, featureC, app_dim):
            n_in = {"MLP_Fea": 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim,
                    "MLP_PE": (3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim,
                    "MLP": (3 + 2 * view_pe * 3) + app_dim}.get(shadingMode)
            return nn.Module() if n_in is None else RenderModule(n_in, featureC)


        class TensorBase(nn.Module):
            # TensorVM's and TensorCP's constructors set no mode tables and
            # allocate no parameters
            allocates = True

            def __init__(self, aabb, gridSize, device, coordinates, density_n_comp=8,
                         appearance_n_comp=24, app_dim=27, shadingMode="MLP_PE",
                         alphaMask=None, near_far=(2.0, 6.0), density_shift=-10,
                         alphaMask_thres=0.001, distance_scale=25,
                         rayMarch_weight_thres=0.0001, pos_pe=6, view_pe=6, fea_pe=6,
                         featureC=128, step_ratio=2.0, fea2denseAct="softplus",
                         use_envmap=False, envmap_res_H=1000):
                super().__init__()
                self.aabb = aabb
                self.gridSize = torch.LongTensor(gridSize)
                self.coordinates = coordinates
                self.density_n_comp = density_n_comp
                self.app_n_comp = appearance_n_comp
                self.app_dim = app_dim
                self.alphaMask = alphaMask
                self.near_far = near_far
                self.density_shift = density_shift
                self.alphaMask_thres = alphaMask_thres
                self.distance_scale = distance_scale
                self.rayMarch_weight_thres = rayMarch_weight_thres
                self.fea2denseAct = fea2denseAct
                self.step_ratio = step_ratio
                self.shadingMode = shadingMode
                self.pos_pe, self.view_pe, self.fea_pe = pos_pe, view_pe, fea_pe
                self.featureC = featureC
                self.use_envmap = use_envmap
                self.envmap_res_H = envmap_res_H
                if self.allocates:
                    self.matMode = [[0, 1], [0, 2], [1, 2]]
                    self.vecMode = [2, 1, 0]
                    self.init_svd_volume(gridSize[0], device)
                self.renderModule = render_module(shadingMode, pos_pe, view_pe, fea_pe,
                                                  featureC, app_dim)
                if use_envmap:
                    self.envmap = EnvironmentMap(envmap_res_H)

            def init_svd_volume(self, res, device):
                raise NotImplementedError

            def grid(self, n, i, plane):
                g = self.gridSize.tolist()
                if plane:
                    m = self.matMode[i]
                    return nn.Parameter(torch.zeros(1, n, g[m[1]], g[m[0]]))
                return nn.Parameter(torch.zeros(1, n, g[self.vecMode[i]], 1))

            def get_kwargs(self):
                return {"aabb": self.aabb, "gridSize": self.gridSize.tolist(),
                        "density_n_comp": self.density_n_comp,
                        "appearance_n_comp": self.app_n_comp, "app_dim": self.app_dim,
                        "density_shift": self.density_shift,
                        "alphaMask_thres": self.alphaMask_thres,
                        "distance_scale": self.distance_scale,
                        "rayMarch_weight_thres": self.rayMarch_weight_thres,
                        "fea2denseAct": self.fea2denseAct, "near_far": self.near_far,
                        "step_ratio": self.step_ratio, "shadingMode": self.shadingMode,
                        "pos_pe": self.pos_pe, "view_pe": self.view_pe, "fea_pe": self.fea_pe,
                        "featureC": self.featureC, "coordinates": self.coordinates,
                        "use_envmap": self.use_envmap}

            def save_masks(self, ckpt):
                if self.alphaMask is not None:
                    vol = self.alphaMask.alpha_volume.bool().cpu().numpy()
                    ckpt["alphaMask.shape"] = vol.shape
                    ckpt["alphaMask.mask"] = np.packbits(vol.reshape(-1))

            def save(self, path, global_step=0):
                ckpt = {"kwargs": self.get_kwargs(), "state_dict": self.state_dict(),
                        "global_step": global_step}
                if self.use_envmap:
                    ckpt["envmap.emission"] = self.envmap.emission.detach().cpu().numpy()
                    ckpt["envmap_res_H"] = self.envmap_res_H
                self.save_masks(ckpt)
                torch.save(ckpt, path)
        ''',
    "tensoRF.py": '''
        """The upstream TensoRF family."""
        from torch import nn

        from .tensorBase import TensorBase


        class TensorVMSplit(TensorBase):
            def init_svd_volume(self, res, device):
                for name, n in (("density", self.density_n_comp), ("app", self.app_n_comp)):
                    setattr(self, f"{name}_plane", nn.ParameterList(
                        [self.grid(n[i], i, True) for i in range(3)]))
                    setattr(self, f"{name}_line", nn.ParameterList(
                        [self.grid(n[i], i, False) for i in range(3)]))
                self.basis_mat = nn.Linear(sum(self.app_n_comp), self.app_dim, bias=False)


        class TensorVM(TensorBase):
            allocates = False

            def init_svd_volume(self, res, device):
                import torch

                n = self.app_n_comp + self.density_n_comp
                self.plane_coef = nn.Parameter(torch.zeros(3, n, res, res))
                self.line_coef = nn.Parameter(torch.zeros(3, n, res, 1))
                self.basis_mat = nn.Linear(self.app_n_comp * 3, self.app_dim, bias=False)


        class TensorCP(TensorBase):
            allocates = False

            def init_svd_volume(self, res, device):
                for name, n in (("density", self.density_n_comp), ("app", self.app_n_comp)):
                    setattr(self, f"{name}_line", nn.ParameterList(
                        [self.grid(n[0], i, False) for i in range(3)]))
                self.basis_mat = nn.Linear(self.app_n_comp[0], self.app_dim, bias=False)
        ''',
    "EgoNeRF.py": '''
        """The upstream EgoNeRF: per-chart planes, lines and basis, the
        yin/yang alpha mask."""
        import numpy as np
        import torch.nn.functional as F
        from torch import nn

        from .tensorBase import TensorBase


        class YinYangAlphaGridMask(nn.Module):
            def __init__(self, device, alpha_volume_yin, alpha_volume_yang):
                super().__init__()
                self.alpha_volume_yin = alpha_volume_yin.to(device)
                self.alpha_volume_yang = alpha_volume_yang.to(device)


        class EgoNeRF(TensorBase):
            def __init__(self, aabb, gridSize, device, coordinates,
                         coarse_sigma_grid_update_rule=None, **kwargs):
                self.coarse_sigma_grid_update_rule = coarse_sigma_grid_update_rule
                super().__init__(aabb, gridSize, device, coordinates, **kwargs)

            def init_svd_volume(self, res, device):
                for name, n in (("density", self.density_n_comp), ("app", self.app_n_comp)):
                    for chart in ("yin", "yang"):
                        setattr(self, f"{name}_plane_{chart}", nn.ParameterList(
                            [self.grid(n[i], i, True) for i in range(3)]))
                        setattr(self, f"{name}_line_{chart}", nn.ParameterList(
                            [self.grid(n[i], i, False) for i in range(3)]))
                for chart in ("yin", "yang"):
                    setattr(self, f"basis_mat_{chart}",
                            nn.Linear(sum(self.app_n_comp), self.app_dim, bias=False))

            def update_coarse_sigma_grid(self):
                self.coarse_sigma_grid = [F.avg_pool2d(p.detach(), 2)
                                          for p in self.density_plane_yin]

            def save_masks(self, ckpt):
                if self.alphaMask is not None:
                    for chart in ("yin", "yang"):
                        vol = getattr(self.alphaMask, f"alpha_volume_{chart}")
                        vol = vol.bool().cpu().numpy()
                        ckpt[f"alphaMask_{chart}.shape"] = vol.shape
                        ckpt[f"alphaMask_{chart}.mask"] = np.packbits(vol.reshape(-1))
        ''',
}

YY_AABB = np.array([[-4.0] * 3, [4.0] * 3], np.float32)
TF_AABB = np.array([[-1.5] * 3, [1.5] * 3], np.float32)
# the upstream checkpoints the parity tests write: the family, its chart
# (class, N_voxel for the radial charts or the grid), the field's widths,
# the envmap's height (0: none) and the alpha-mask volumes' shape
CASES = {
    "egonerf": dict(family="EgoNeRF", chart="YinYangSphericalCoords", n_voxel=16 ** 3,
                    n=([4, 4, 4], [8, 8, 8]), shading="MLP_Fea"),
    "egonerf_env_masks": dict(family="EgoNeRF", chart="YinYangSphericalCoords",
                              n_voxel=16 ** 3, n=([4, 4, 4], [8, 8, 8]), shading="MLP_Fea",
                              env=8, mask=(6, 5, 7)),
    "egonerf_mlp": dict(family="EgoNeRF", chart="YinYangSphericalCoords", n_voxel=12 ** 3,
                        n=([2, 3, 4], [4, 6, 8]), shading="MLP"),
    "vmsplit_mask": dict(family="TensorVMSplit", chart="CartesianCoords", grid=[20, 22, 24],
                         n=([4, 4, 4], [8, 8, 8]), shading="MLP_Fea", mask=(4, 5, 6)),
    "vmsplit_generic_env": dict(family="TensorVMSplit", chart="GenericSphericalCoords",
                                n_voxel=14 ** 3, n=([4, 4, 4], [8, 8, 8]), shading="MLP_PE",
                                env=6),
    "vmsplit_cylinder": dict(family="TensorVMSplit", chart="CylindricalCoords",
                             grid=[12, 10, 14], n=([2, 2, 2], [4, 4, 4]), shading="MLP_Fea"),
    "vm": dict(family="TensorVM", chart="CartesianCoords", grid=[24, 24, 24], n=(4, 8),
               shading="MLP_Fea"),
    "cp": dict(family="TensorCP", chart="CartesianCoords", grid=[24, 24, 24], n=([8], [16]),
               shading="MLP_PE", mask=(5, 5, 5)),
}
_PORT_NAME = {"YinYangSphericalCoords": "yinyang", "CartesianCoords": "xyz",
              "GenericSphericalCoords": "generic_sphere", "CylindricalCoords": "cylinder"}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The stand-in upstream checkout, written once for the module."""
    root = tmp_path_factory.mktemp("upstream")
    (root / "models").mkdir()
    for name, src in STANDIN.items():
        (root / "models" / name).write_text(textwrap.dedent(src))
    return str(root)


def _owned(name):
    return name == "models" or name.startswith("models.") or name in _STUBS


@pytest.fixture(autouse=True)
def _restore_modules():
    """Put ``sys.path`` and every ``models*`` and stub entry of
    ``sys.modules`` back as they were before the test."""
    path = list(sys.path)
    before = {k: v for k, v in sys.modules.items() if _owned(k)}
    yield
    sys.path[:] = path
    for k in [k for k in sys.modules if _owned(k)]:
        del sys.modules[k]
    sys.modules.update(before)


@contextlib.contextmanager
def upstream(reference):
    """The upstream ``models`` package imported from ``reference``."""
    _stub_ref_deps()
    sys.path.insert(0, reference)
    try:
        import models.coordinates
        import models.EgoNeRF
        import models.tensoRF
        import models.tensorBase
        yield models
    finally:
        sys.path.remove(reference)


def _grid(case):
    """The case's chart in the port and its grid."""
    name = _PORT_NAME[case["chart"]]
    if "n_voxel" in case:
        coords = make_coordinates(name, YY_AABB if name == "yinyang" else TF_AABB, exp_r=True,
                                  N_voxel=case["n_voxel"], r0=0.05, interval_th=True)
        return coords, [int(g) for g in coords.resolution]
    coords = make_coordinates(name, TF_AABB)
    coords.set_resolution(list(case["grid"]))
    return coords, list(case["grid"])


def _mask_volumes(case, rng):
    n = 2 if case["family"] == "EgoNeRF" else 1
    return [rng.random(case["mask"]) < 0.4 for _ in range(n)]


def write_upstream(reference, path, case, seed, global_step=0, **kwarg_deltas):
    """A .th of ``case`` written by the stand-in's ``save``: every
    parameter drawn from ``seed`` with numpy, the alpha masks (if the case
    has them) too.  Returns the path."""
    rng = np.random.default_rng(seed)
    _, grid = _grid(case)
    aabb = torch.tensor(YY_AABB if case["family"] == "EgoNeRF" else TF_AABB)
    with upstream(reference) as m:
        cls = getattr(m.coordinates, case["chart"])
        if "n_voxel" in case:
            coords = cls("cpu", aabb, exp_r=True, N_voxel=case["n_voxel"], r0=0.05,
                         interval_th=True)
            coords.set_resolution(grid, r0=0.05)
        else:
            coords = cls("cpu", aabb)
        nd, na = case["n"]
        kwargs = dict(density_n_comp=nd, appearance_n_comp=na, app_dim=12,
                      near_far=[0.05, 4.0], shadingMode=case["shading"], density_shift=-8,
                      distance_scale=25, pos_pe=3, view_pe=2, fea_pe=2, featureC=32,
                      fea2denseAct="softplus", step_ratio=0.5, alphaMask_thres=2e-3,
                      rayMarch_weight_thres=1e-3, use_envmap=bool(case.get("env")),
                      envmap_res_H=case.get("env", 1000))
        kwargs.update(kwarg_deltas)
        if case["family"] == "EgoNeRF":
            ref = m.EgoNeRF.EgoNeRF(aabb, grid, "cpu", coords,
                                    coarse_sigma_grid_update_rule="conv", **kwargs)
        else:
            ref = getattr(m.tensoRF, case["family"])(aabb, grid, "cpu", coords, **kwargs)
            if case["family"] in ("TensorVM", "TensorCP"):
                ref.matMode = [[0, 1], [0, 2], [1, 2]]
                ref.vecMode = [2, 1, 0]
                ref.init_svd_volume(grid[0], "cpu")
        with torch.no_grad():
            for _, p in sorted(ref.named_parameters()):
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        if "mask" in case:
            vols = [torch.from_numpy(v.astype(np.float32)) for v in _mask_volumes(case, rng)]
            if case["family"] == "EgoNeRF":
                ref.alphaMask = m.EgoNeRF.YinYangAlphaGridMask("cpu", *vols)
            else:
                ref.alphaMask = m.tensorBase.AlphaGridMask("cpu", vols[0])
        ref.save(str(path), global_step=global_step)
    return str(path)


def read_th(reference, path):
    with upstream(reference):
        return torch.load(path, map_location="cpu", weights_only=False)


def npz_contents(path):
    """(every array but the header, the header)."""
    with np.load(path, allow_pickle=False) as data:
        header = json.loads(bytes(data["__header__"]).decode())
        return {k: data[k] for k in data.files if k != "__header__"}, header


def assert_same_npz(a, b):
    arrays_a, header_a = npz_contents(a)
    arrays_b, header_b = npz_contents(b)
    assert header_a == header_b
    assert sorted(arrays_a) == sorted(arrays_b)
    for k in arrays_a:
        assert arrays_a[k].dtype == arrays_b[k].dtype, k
        np.testing.assert_array_equal(arrays_a[k], arrays_b[k], err_msg=k)


def assert_same(a, b, where="ckpt"):
    """Recursive equality of .th contents: tensors and arrays bit for bit,
    objects (the pickled chart) by class and attributes."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__module__ == type(b).__module__, where
        assert type(a).__qualname__ == type(b).__qualname__, where
        assert_same(vars(a), vars(b), f"{where}.__dict__")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def port_convert(th, out, reference):
    return import_reference_ckpt.convert(th, out, reference=reference, device="cpu")


def port_export(npz, out, reference, **kw):
    return export_reference_ckpt.export(npz, out, reference=reference, device="cpu", **kw)


def _raised(fn) -> BaseException:
    with pytest.raises(BaseException) as info:
        fn()
    return info.value


# ---------------------------------------------------------------------------
# the stand-in pinned to JAX's mapping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_standin_round_trips_through_jax(reference, tmp_path, name):
    """JAX's convert -> export -> convert through the stand-in: the two
    npz files are equal array for array (header included), and the .th
    that JAX's export writes holds the seeded upstream state_dict, masks
    and envmap bit for bit."""
    case = CASES[name]
    th = write_upstream(reference, tmp_path / "seeded.th", case, seed=1, global_step=41)
    npz1, th2, npz2 = (str(tmp_path / f) for f in ("a.npz", "b.th", "b.npz"))
    info = jax_import_mod.convert(th, npz1, reference=reference)
    assert info["global_step"] == 41
    assert info["alpha_masks"] == ("mask" in case)
    assert info["use_envmap"] == bool(case.get("env"))
    jax_export_mod.export(npz1, th2, reference=reference, near_far=[0.05, 4.0])
    jax_import_mod.convert(th2, npz2, reference=reference)
    assert_same_npz(npz1, npz2)
    src, back = read_th(reference, th), read_th(reference, th2)
    assert_same(src["state_dict"], back["state_dict"], "state_dict")
    assert sorted(src) == sorted(back)
    for k in src:
        if k not in ("kwargs", "state_dict"):
            assert_same(src[k], back[k], k)
    _, header = npz_contents(npz1)
    assert header["model_meta"]["model_name"] == case["family"]
    assert header["coords_spec"]["name"] == _PORT_NAME[case["chart"]]


# ---------------------------------------------------------------------------
# the port against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_import_matches_jax(reference, tmp_path, name):
    """The port's ``convert`` and JAX's on one seeded upstream .th: the
    npz files are equal array for array and mask for mask, their headers
    (coords_spec, model_meta, global_step, param_keys, the masks' shapes)
    equal, and so are the returned dicts; the masks are the seeded ones."""
    case = CASES[name]
    th = write_upstream(reference, tmp_path / "seeded.th", case, seed=2, global_step=777)
    want = jax_import_mod.convert(th, str(tmp_path / "jax.npz"), reference=reference)
    got = port_convert(th, str(tmp_path / "port.npz"), reference)
    assert {**got, "out": None} == {**want, "out": None}
    assert_same_npz(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"))
    masks = load_alpha_masks(str(tmp_path / "port.npz"))
    if "mask" in case:
        ckpt = read_th(reference, th)
        for j, key in enumerate(("alphaMask_yin", "alphaMask_yang")
                                if case["family"] == "EgoNeRF" else ("alphaMask",)):
            shape = tuple(ckpt[f"{key}.shape"])[-3:]
            n = int(np.prod(shape))
            np.testing.assert_array_equal(
                masks[f"alpha_{j}"], np.unpackbits(ckpt[f"{key}.mask"])[:n].reshape(shape) > 0)
    else:
        assert not masks


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("near_far", [None, [0.5, 3.0]], ids=["default_near_far", "near_far"])
def test_export_matches_jax(reference, tmp_path, name, near_far):
    """JAX's ``export`` and the port's on one npz: every state_dict tensor
    equal, the kwargs equal (the pickled chart by class and attributes),
    global_step, the alphaMask_* and envmap entries; and the returned
    dicts."""
    case = CASES[name]
    th = write_upstream(reference, tmp_path / "seeded.th", case, seed=3, global_step=88)
    npz = str(tmp_path / "src.npz")
    jax_import_mod.convert(th, npz, reference=reference)
    want = jax_export_mod.export(npz, str(tmp_path / "jax.th"), reference=reference,
                                 near_far=near_far)
    got = port_export(npz, str(tmp_path / "port.th"), reference, near_far=near_far)
    assert {**got, "out": None} == {**want, "out": None}
    assert_same(read_th(reference, str(tmp_path / "jax.th")),
                read_th(reference, str(tmp_path / "port.th")))


def _legacy_npz(reference, tmp_path, name):
    """An npz of ``case`` whose model_meta lacks model_name."""
    th = write_upstream(reference, tmp_path / "seeded.th", CASES[name], seed=4, global_step=5)
    npz = str(tmp_path / "full.npz")
    port_convert(th, npz, reference)
    flat, header = load_checkpoint(npz)
    meta = {k: v for k, v in header["model_meta"].items() if k != "model_name"}
    from egonerf_torch.models import params_from_jax

    legacy = str(tmp_path / "legacy.npz")
    save_checkpoint(legacy, params_from_jax(flat, device="cpu"), global_step=5,
                    coords_spec=header["coords_spec"], model_meta=meta,
                    alpha_masks=load_alpha_masks(npz) or None)
    return legacy


@pytest.mark.parametrize("name,family", [("cp", None), ("vm", "TensorVM"),
                                         ("vm", "TensorVMSplit"),
                                         ("vmsplit_mask", "TensorVMSplit")])
def test_legacy_export_matches_jax(reference, tmp_path, name, family):
    """A checkpoint without model_name: CP inferred from its lack of
    planes, or the family given (``--family=``); both packages write the
    same .th and name the same family."""
    legacy = _legacy_npz(reference, tmp_path, name)
    want = jax_export_mod.export(legacy, str(tmp_path / "jax.th"), reference=reference,
                                 family=family)
    got = port_export(legacy, str(tmp_path / "port.th"), reference, family=family)
    assert got["family"] == want["family"] == (family or "TensorCP")
    assert {**got, "out": None} == {**want, "out": None}
    assert_same(read_th(reference, str(tmp_path / "jax.th")),
                read_th(reference, str(tmp_path / "port.th")))


# ---------------------------------------------------------------------------
# the port's own full circle, and the imported model's render
# ---------------------------------------------------------------------------
def _port_model(name, seed):
    """A port model of ``case`` with seeded parameters (and alpha masks)."""
    case = CASES[name]
    coords, grid = _grid(case)
    nd, na = case["n"]
    ncomp = (lambda v: tuple(np.atleast_1d(v).tolist() * 3) if np.ndim(v) == 0 or len(v) == 1
             else tuple(v))
    cfg = FieldConfig(density_n_comp=ncomp(nd), app_n_comp=ncomp(na), app_dim=12,
                      shading_mode=case["shading"], pos_pe=3, view_pe=2, fea_pe=2, feature_c=32,
                      use_envmap=bool(case.get("env")), envmap_res_h=case.get("env", 1000))
    aabb = YY_AABB if case["family"] == "EgoNeRF" else TF_AABB
    model = MODELS[case["family"]](aabb, grid, coords, cfg, near_far=(0.05, 4.0), device="cpu")
    params = model.init_params(torch.Generator().manual_seed(seed))
    if "mask" in case:
        rng = np.random.default_rng(seed)
        model.alpha_mask = mask_from_volumes(_mask_volumes(case, rng), "cpu")
    return model, params, coords


def _render(model, params):
    rng = np.random.default_rng(7)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-0.1, 0.1, size=(64, 3)).astype(np.float32)
    rays = torch.from_numpy(np.concatenate([o, d], -1))
    kw = (dict(n_coarse=16, n_fine=16) if type(model).__name__ == "EgoNeRF"
          else dict(n_coarse=40))
    with torch.no_grad():
        return model.forward(params, rays, **kw)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_export_import_is_identity(reference, tmp_path, name):
    """The port's export -> the port's import gives back the npz it
    started from, array for array; the imported npz loads through
    ``load_jax_checkpoint`` and renders a fixed batch of rays bit for bit
    as the source parameters do."""
    model, params, coords = _port_model(name, seed=5)
    npz0, th, npz1 = (str(tmp_path / f) for f in ("src.npz", "out.th", "back.npz"))
    save_checkpoint(npz0, params, global_step=55, coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    info = port_export(npz0, th, reference, near_far=[0.05, 4.0])
    assert info["global_step"] == 55 and info["alpha_masks"] == ("mask" in CASES[name])
    port_convert(th, npz1, reference)
    a0, h0 = npz_contents(npz0)
    a1, h1 = npz_contents(npz1)
    assert sorted(a0) == sorted(a1)
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert h1["global_step"] == 55
    assert h1["model_meta"] == h0["model_meta"]
    assert h1["alpha_masks"] if "mask" in CASES[name] else "alpha_masks" not in h1
    loaded, loaded_params, _ = load_jax_checkpoint(npz1, near_far=(0.05, 4.0), device="cpu")
    want, got = _render(model, params), _render(loaded, loaded_params)
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("name", ["egonerf_env_masks", "vmsplit_generic_env", "cp"])
def test_imported_checkpoint_loads_as_the_trainer_resumes(reference, tmp_path, name):
    """An upstream .th of the port's seeded model, imported, loads through
    the trainer's own resume path (``--ckpt``: the checkpoint's family
    over the config's, its masks reinstalled) and renders bit for bit as
    the source."""
    from egonerf_torch.train.config import load_config
    from egonerf_torch.train.trainer import _load_model

    model, params, coords = _port_model(name, seed=13)
    npz0, th, npz1 = (str(tmp_path / f) for f in ("src.npz", "out.th", "back.npz"))
    save_checkpoint(npz0, params, global_step=9, coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    port_export(npz0, th, reference, near_far=[0.05, 4.0])
    port_convert(th, npz1, reference)
    resumed, header = _load_model(load_config(overrides={"ckpt": npz1}), npz1, model.aabb,
                                  (0.05, 4.0), "cpu")
    assert type(resumed) is type(model) and header["global_step"] == 9
    assert (resumed.alpha_mask is None) == (model.alpha_mask is None)
    if model.alpha_mask is not None:
        assert torch.equal(resumed.alpha_mask.vol, model.alpha_mask.vol)
    want, got = _render(model, params), _render(resumed, resumed.params())
    for k in ("rgb", "depth", "acc"):
        assert torch.equal(want[k], got[k]), k


# ---------------------------------------------------------------------------
# refusals and the command lines
# ---------------------------------------------------------------------------
def _refusal_th(reference, tmp_path, kind):
    """An upstream .th that the import refuses for ``kind``."""
    path = tmp_path / f"{kind}.th"
    if kind == "layout":
        th = write_upstream(reference, path, CASES["vm"], seed=6)
        ckpt = read_th(reference, th)
        ckpt["state_dict"] = {f"renamed_{k}": v for k, v in ckpt["state_dict"].items()}
        with upstream(reference):
            torch.save(ckpt, th)
        return th
    if kind == "egonerf_chart":
        th = write_upstream(reference, path, CASES["egonerf"], seed=6)
        ckpt = read_th(reference, th)
        with upstream(reference) as m:
            ckpt["kwargs"]["coordinates"] = m.coordinates.GenericSphericalCoords(
                "cpu", ckpt["kwargs"]["aabb"], exp_r=True, N_voxel=16 ** 3, r0=0.05)
            torch.save(ckpt, th)
        return th
    if kind in ("SH", "RGB"):
        return write_upstream(reference, path, CASES["vmsplit_mask"], seed=6, shadingMode=kind)
    if kind == "chart_class":
        th = write_upstream(reference, path, CASES["vmsplit_mask"], seed=6)
        ckpt = read_th(reference, th)
        with upstream(reference) as m:
            ckpt["kwargs"]["coordinates"] = m.coordinates.YinYangSphericalCoords(
                "cpu", ckpt["kwargs"]["aabb"])
            torch.save(ckpt, th)
        return th
    if kind in ("shape_grid", "shape_shader", "shape_basis"):
        name = "egonerf" if kind == "shape_basis" else "vmsplit_mask"
        th = write_upstream(reference, path, CASES[name], seed=6)
        ckpt = read_th(reference, th)
        if kind == "shape_grid":
            ckpt["kwargs"]["gridSize"] = [g + 1 for g in ckpt["kwargs"]["gridSize"]]
        elif kind == "shape_shader":
            ckpt["kwargs"]["featureC"] = 16
        else:
            ckpt["kwargs"]["app_dim"] = 10
        with upstream(reference):
            torch.save(ckpt, th)
        return th
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["layout", "egonerf_chart", "SH", "RGB", "chart_class",
                                  "shape_grid", "shape_shader", "shape_basis"])
def test_import_refusals_match_jax(reference, tmp_path, kind):
    """Each of JAX's refusals: the same exception type and message."""
    th = _refusal_th(reference, tmp_path, kind)
    want = _raised(lambda: jax_import_mod.convert(th, str(tmp_path / "j.npz"),
                                                  reference=reference))
    got = _raised(lambda: port_convert(th, str(tmp_path / "p.npz"), reference))
    assert type(got) is type(want) is SystemExit
    assert str(got) == str(want) and str(got)
    assert not os.path.exists(tmp_path / "p.npz")


@pytest.mark.parametrize("tool", ["import", "export"])
def test_missing_checkout_refusal_matches_jax(tmp_path, tool):
    """No checkout at ``--reference``: JAX's SystemExit and message."""
    missing = str(tmp_path / "no_checkout")
    if tool == "import":
        want = _raised(lambda: jax_import_mod.convert("x.th", "y.npz", reference=missing))
        got = _raised(lambda: port_convert("x.th", "y.npz", missing))
    else:
        want = _raised(lambda: jax_export_mod.export("x.npz", "y.th", reference=missing))
        got = _raised(lambda: port_export("x.npz", "y.th", missing))
    assert type(got) is type(want) is SystemExit
    assert str(got) == str(want) and missing in str(got)


@pytest.mark.parametrize("name", ["vmsplit_mask", "vm"])
def test_legacy_vm_refusal_matches_jax(reference, tmp_path, name):
    """A VM/VMSplit checkpoint without model_name and no ``--family``:
    JAX's refusal, word for word."""
    legacy = _legacy_npz(reference, tmp_path, name)
    want = _raised(lambda: jax_export_mod.export(legacy, str(tmp_path / "j.th"),
                                                 reference=reference))
    got = _raised(lambda: port_export(legacy, str(tmp_path / "p.th"), reference))
    assert type(got) is type(want) is SystemExit
    assert str(got) == str(want) and "--family=TensorVMSplit" in str(got)


def test_tools_take_the_card_by_default(reference, tmp_path, monkeypatch):
    """``convert`` and ``export`` default to the card and raise without
    one before reading anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: import_reference_ckpt.convert("x.th", "y.npz", reference=reference),
                 lambda: export_reference_ckpt.export("x.npz", "y.th", reference=reference)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def _main_out(capsys, fn):
    fn()
    return capsys.readouterr().out


@pytest.mark.parametrize("order", ["positionals_first", "option_first"])
def test_import_main_matches_jax(reference, tmp_path, monkeypatch, capsys, order):
    """Both ``main``s on JAX's argument list print the same JSON line and
    write the same npz."""
    th = write_upstream(reference, tmp_path / "seeded.th", CASES["egonerf_env_masks"], seed=8,
                        global_step=12)
    out = str(tmp_path / "out.npz")
    argv = [th, out, f"--reference={reference}"]
    if order == "option_first":
        argv = argv[2:] + argv[:2]
    monkeypatch.setattr("sys.argv", ["import_reference_ckpt.py", *argv])
    want = _main_out(capsys, jax_import_mod.main)
    os.rename(out, str(tmp_path / "jax.npz"))
    monkeypatch.setattr(import_reference_ckpt, "convert",
                        functools.partial(import_reference_ckpt.convert, device="cpu"))
    got = _main_out(capsys, lambda: import_reference_ckpt.main(argv))
    assert got == want and json.loads(got)["global_step"] == 12
    assert_same_npz(out, str(tmp_path / "jax.npz"))


@pytest.mark.parametrize("extra", [[], ["--near_far=0.5,3.0"], ["--near_far=[0.25,2.0]"],
                                   ["--family=TensorVMSplit"]])
def test_export_main_matches_jax(reference, tmp_path, monkeypatch, capsys, extra):
    """Both ``main``s on JAX's argument lists (``--near_far=`` with and
    without brackets, ``--family=``) print the same JSON line and write
    the same .th."""
    th = write_upstream(reference, tmp_path / "seeded.th", CASES["vm"], seed=9, global_step=3)
    npz = str(tmp_path / "src.npz")
    port_convert(th, npz, reference)
    out = str(tmp_path / "out.th")
    argv = [npz, out, f"--reference={reference}", *extra]
    monkeypatch.setattr("sys.argv", ["export_reference_ckpt.py", *argv])
    want = _main_out(capsys, jax_export_mod.main)
    want_th = read_th(reference, out)
    monkeypatch.setattr(export_reference_ckpt, "export",
                        functools.partial(export_reference_ckpt.export, device="cpu"))
    got = _main_out(capsys, lambda: export_reference_ckpt.main(argv))
    assert got == want and json.loads(got)["family"] == (
        "TensorVMSplit" if extra[:1] == ["--family=TensorVMSplit"] else "TensorVM")
    assert_same(want_th, read_th(reference, out))


@pytest.mark.parametrize("tool", ["import", "export"])
def test_mains_refuse_a_wrong_argument_count(tool, monkeypatch):
    """One positional: both ``main``s exit with their usage."""
    jax_mod, mod = ((jax_import_mod, import_reference_ckpt) if tool == "import"
                    else (jax_export_mod, export_reference_ckpt))
    monkeypatch.setattr("sys.argv", ["tool.py", "only.th"])
    want = _raised(jax_mod.main)
    got = _raised(lambda: mod.main(["only.th"]))
    assert type(got) is type(want) is SystemExit
    assert "Usage:" in str(got) and "egonerf_torch.tools" in str(got)


# ---------------------------------------------------------------------------
# the real upstream checkout, where it is present (mirrors of JAX's
# reference-gated round trips in tests/test_reference_parity.py)
# ---------------------------------------------------------------------------
needs_reference = pytest.mark.skipif(not os.path.isdir(REFERENCE),
                                     reason="reference checkout not present")


@needs_reference
@pytest.mark.parametrize("name", ["egonerf", "egonerf_env_masks", "vmsplit_mask", "vm", "cp"])
def test_real_upstream_export_import_full_circle(tmp_path, name):
    """The port's export into the real upstream classes and its import
    back: every array bit for bit, and the same render."""
    model, params, coords = _port_model(name, seed=10)
    npz0, th, npz1 = (str(tmp_path / f) for f in ("src.npz", "out.th", "back.npz"))
    save_checkpoint(npz0, params, global_step=55, coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    info = port_export(npz0, th, REFERENCE, near_far=[0.05, 4.0])
    assert info["global_step"] == 55
    port_convert(th, npz1, REFERENCE)
    a0, _ = npz_contents(npz0)
    a1, h1 = npz_contents(npz1)
    assert sorted(a0) == sorted(a1) and h1["global_step"] == 55
    for k in a0:
        np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    loaded, loaded_params, _ = load_jax_checkpoint(npz1, near_far=(0.05, 4.0), device="cpu")
    want, got = _render(model, params), _render(loaded, loaded_params)
    for k in ("rgb", "depth"):
        assert torch.equal(want[k], got[k]), k


@needs_reference
@pytest.mark.parametrize("name", ["egonerf_env_masks", "vmsplit_mask", "vm", "cp"])
def test_real_upstream_import_matches_jax(tmp_path, name):
    """A .th the real upstream ``save`` wrote (from the port's export):
    the port's import and JAX's give the same npz."""
    model, params, coords = _port_model(name, seed=11)
    npz0, th = str(tmp_path / "src.npz"), str(tmp_path / "out.th")
    save_checkpoint(npz0, params, global_step=777, coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    port_export(npz0, th, REFERENCE, near_far=[0.05, 4.0])
    want = jax_import_mod.convert(th, str(tmp_path / "jax.npz"), reference=REFERENCE)
    got = port_convert(th, str(tmp_path / "port.npz"), REFERENCE)
    assert {**got, "out": None} == {**want, "out": None}
    assert_same_npz(str(tmp_path / "jax.npz"), str(tmp_path / "port.npz"))


@needs_reference
@pytest.mark.parametrize("name", ["egonerf_env_masks", "vmsplit_mask", "vm", "cp"])
def test_real_upstream_export_matches_jax(tmp_path, name):
    """JAX's export and the port's into the real upstream classes write
    the same checkpoint."""
    model, params, coords = _port_model(name, seed=12)
    npz0 = str(tmp_path / "src.npz")
    save_checkpoint(npz0, params, global_step=88, coords_spec=coords.to_spec(),
                    model_meta=model_meta(None, model), alpha_masks=mask_volumes(model))
    jax_export_mod.export(npz0, str(tmp_path / "jax.th"), reference=REFERENCE,
                          near_far=[0.05, 4.0])
    port_export(npz0, str(tmp_path / "port.th"), REFERENCE, near_far=[0.05, 4.0])
    _stub_ref_deps()
    sys.path.insert(0, REFERENCE)
    a = torch.load(str(tmp_path / "jax.th"), map_location="cpu", weights_only=False)
    b = torch.load(str(tmp_path / "port.th"), map_location="cpu", weights_only=False)
    assert_same(a["state_dict"], b["state_dict"], "state_dict")
    assert sorted(a) == sorted(b) and a["global_step"] == b["global_step"] == 88
