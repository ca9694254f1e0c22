"""Dataset fetcher for the EgoNeRF benchmark scenes (the port's copy of
``egonerf_tpu/tools/fetch_data.py``, which it may not import).

The upstream datasets (OmniBlender and Ricoh360) are distributed through
a Google Drive folder.  The tool (a) succeeds at once when the scene is
already on disk, (b) otherwise tries a download through ``gdown``, then
a plain-HTTP probe of the folder (10 s timeout), and (c) otherwise prints
the manual instructions and exits 3, so ``real_data_run`` works on the
day the data arrives with no new code.

One departure from the JAX tool: :func:`is_present` also accepts
``imgs/``, the folder the egocentric (Ricoh360) loader reads
(``data/datasets.py``); the JAX tool misses a Ricoh scene that its own
loader can read.

Usage:  python -m egonerf_torch.tools.fetch_data [scene] [--dest data]
Exit codes: 0 data present (already or fetched), 3 unreachable.
"""
from __future__ import annotations

import os
import sys

DRIVE_FOLDER = "1kqLAATjSSDwfLHI5O7RTfM9NOUi7PvcK"
DATASETS = {
    # scene -> collection dir; exactly the 11 + 11 scenes under
    # configs/egonerf/{omniblender,ricoh}/
    **{s: "OmniBlender" for s in (
        "barbershop", "lone_monk", "archiviz-flat", "classroom", "restroom",
        "bistro_bike", "bistro_square", "fisher-hut", "LOU",
        "pavilion_midday_chair", "pavilion_midday_pond")},
    **{s: "Ricoh360" for s in (
        "bricks", "bridge", "bridge_under", "cat_tower", "center", "farm",
        "flower", "garden", "gallery_chair", "gallery_pillar", "poster")},
}
# any one of these entries marks a scene directory as usable: the JAX
# tool's five, and imgs/, which the egocentric loader reads
SCENE_ENTRIES = frozenset({"images", "image", "transforms.json", "cam_models", "poses",
                           "imgs"})


def scene_dir(scene: str, dest: str = "data") -> str:
    return os.path.join(dest, DATASETS[scene], scene)


def is_present(scene: str, dest: str = "data") -> bool:
    """A usable scene is a directory holding any one of
    :data:`SCENE_ENTRIES` (the loaders' on-disk contract)."""
    d = scene_dir(scene, dest)
    if not os.path.isdir(d):
        return False
    return bool(set(os.listdir(d)) & SCENE_ENTRIES)


def try_fetch(scene: str, dest: str = "data") -> bool:
    """Best-effort download; True only if the scene is present after."""
    target = scene_dir(scene, dest)
    try:
        import gdown  # type: ignore

        os.makedirs(os.path.dirname(target), exist_ok=True)
        gdown.download_folder(id=DRIVE_FOLDER, output=os.path.dirname(target),
                              quiet=False)
    except ImportError:
        print("gdown not installed; trying plain HTTP probe", file=sys.stderr)
        try:
            import urllib.request

            urllib.request.urlopen(
                "https://drive.google.com/drive/folders/" + DRIVE_FOLDER,
                timeout=10)
            print("Drive reachable but folder download needs gdown — "
                  "`pip install gdown` and re-run.", file=sys.stderr)
        except Exception as e:  # noqa: BLE001 — no route to the folder
            print(f"network unreachable ({type(e).__name__}: {e})",
                  file=sys.stderr)
    except Exception as e:  # noqa: BLE001
        print(f"download failed ({type(e).__name__}: {e})", file=sys.stderr)
    return is_present(scene, dest)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    dest = "data"
    if "--dest" in argv:
        i = argv.index("--dest")
        dest = argv[i + 1]
        del argv[i:i + 2]
    scene = argv[0] if argv else "barbershop"
    if scene not in DATASETS:
        raise SystemExit(f"unknown scene {scene!r}; one of {sorted(DATASETS)}")

    if is_present(scene, dest):
        print(f"{scene_dir(scene, dest)}: present")
        return 0
    if try_fetch(scene, dest):
        print(f"{scene_dir(scene, dest)}: fetched")
        return 0
    print(f"""\
{scene_dir(scene, dest)}: ABSENT and not fetchable from this machine.
Manual path: download the '{DATASETS[scene]}' collection from
  https://drive.google.com/drive/folders/{DRIVE_FOLDER}
and unpack so that {scene_dir(scene, dest)}/ holds the scene's images and
trajectory files.  Then re-run: every real-data tool keys off that
directory.""")
    return 3


if __name__ == "__main__":
    raise SystemExit(main())
