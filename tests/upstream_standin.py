"""A stand-in of the upstream PyTorch EgoNeRF checkout, for the tests of
the tools that import it (the checkpoint bridge, the head-to-head run).

``STANDIN`` is a ``models/`` package with the upstream class names (the
nine coordinate classes, ``EgoNeRF`` and ``YinYangAlphaGridMask``,
TensorVMSplit, TensorVM and TensorCP, ``AlphaGridMask``), the parameter
names and shapes the tools read and write, a ``save`` that writes the
entries the import reads, and on ``EgoNeRF`` what the head-to-head run
calls: ``get_optparam_groups``, a forward and ``update_coarse_sigma_grid``,
each written into the module's ``RECORD``.  It holds the upstream's
layout, not its numerics.
"""
import contextlib
import sys
import textwrap

STUBS = ("torchvision", "torchvision.transforms", "kornia", "cv2", "plyfile", "skimage",
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
        yin/yang alpha mask; for the head-to-head run its optimizer groups,
        a forward whose output moves with every parameter, and the coarse
        grid's update, each written into RECORD."""
        import numpy as np
        import torch
        import torch.nn.functional as F
        from torch import nn

        from .tensorBase import TensorBase

        # what a caller handed this module: each constructor's arguments,
        # each get_optparam_groups call (its lrs and the groups it returned),
        # each forward (its rays, keywords, grad mode and the lrs of the
        # newest groups at the call), the coarse grid's updates and the
        # state_dict at the first one
        RECORD = {"init": [], "groups": [], "calls": [], "updates": 0, "copied": None}


        def _plain(v):
            return v.tolist() if hasattr(v, "tolist") else v


        class YinYangAlphaGridMask(nn.Module):
            def __init__(self, device, alpha_volume_yin, alpha_volume_yang):
                super().__init__()
                self.alpha_volume_yin = alpha_volume_yin.to(device)
                self.alpha_volume_yang = alpha_volume_yang.to(device)


        class EgoNeRF(TensorBase):
            def __init__(self, aabb, gridSize, device, coordinates,
                         coarse_sigma_grid_update_rule=None, **kwargs):
                RECORD["init"].append(dict(
                    aabb=_plain(aabb), aabb_dtype=str(aabb.dtype),
                    gridSize=[int(g) for g in gridSize], device=device,
                    chart=type(coordinates).__name__,
                    chart_args={k: _plain(v) for k, v in vars(coordinates).items()},
                    coarse_sigma_grid_update_rule=coarse_sigma_grid_update_rule,
                    kwargs=dict(kwargs)))
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

            def get_optparam_groups(self, lr_init_spatialxyz=0.02, lr_init_network=0.001,
                                    lr_envmap=0.005):
                grids = [p for name in ("density_plane", "density_line", "app_plane", "app_line")
                         for chart in ("yin", "yang") for p in getattr(self, f"{name}_{chart}")]
                network = [*self.basis_mat_yin.parameters(), *self.basis_mat_yang.parameters(),
                           *self.renderModule.parameters()]
                groups = [{"params": grids, "lr": lr_init_spatialxyz},
                          {"params": network, "lr": lr_init_network}]
                if self.use_envmap:
                    groups.append({"params": [self.envmap.emission], "lr": lr_envmap})
                RECORD["groups"].append(dict(
                    lrs=(lr_init_spatialxyz, lr_init_network, lr_envmap), groups=groups))
                return groups

            def forward(self, rays_chunk, pretrain_envmap=False, **kwargs):
                # Adam holds the dicts get_optparam_groups returned: their lr
                # is the one the step after this forward applies
                groups = RECORD["groups"][-1]["groups"] if RECORD["groups"] else []
                RECORD["calls"].append(dict(
                    rays=rays_chunk.detach().cpu().numpy().copy(),
                    pretrain_envmap=pretrain_envmap, kwargs=dict(kwargs),
                    grad=torch.is_grad_enabled(), lrs=[g["lr"] for g in groups]))
                total = sum(p.mean() for p in self.parameters())
                rgb = torch.sigmoid(rays_chunk[:, 3:6] + total)
                return rgb if pretrain_envmap else (rgb, rays_chunk[:, 0])

            def update_coarse_sigma_grid(self):
                RECORD["updates"] += 1
                if RECORD["copied"] is None:
                    RECORD["copied"] = {k: v.detach().cpu().clone()
                                        for k, v in self.state_dict().items()}
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


def write_checkout(root) -> str:
    """Write the stand-in under ``root`` (a ``pathlib.Path``); returns it as
    a string."""
    (root / "models").mkdir()
    for name, src in STANDIN.items():
        (root / "models" / name).write_text(textwrap.dedent(src))
    return str(root)


def owned(name) -> bool:
    """Whether ``sys.modules[name]`` is the stand-in's or a stub the tools
    put there."""
    return name == "models" or name.startswith("models.") or name in STUBS


@contextlib.contextmanager
def restored_modules():
    """Put ``sys.path`` and every ``models*`` and stub entry of
    ``sys.modules`` back as they were before the block."""
    path = list(sys.path)
    before = {k: v for k, v in sys.modules.items() if owned(k)}
    try:
        yield
    finally:
        sys.path[:] = path
        for k in [k for k in sys.modules if owned(k)]:
            del sys.modules[k]
        sys.modules.update(before)


@contextlib.contextmanager
def upstream(reference):
    """The upstream ``models`` package imported from ``reference``."""
    from egonerf_torch.tools.reference_layout import _stub_ref_deps

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
