"""Command line: ``python -m egonerf_torch --config configs/....txt [--key value]``
trains on the card; ``--evaluation 1`` renders the test set from the newest
checkpoint and prints its PSNR (counterpart of ``egonerf_tpu/__main__.py``).

Under ``python -m torch.distributed.run --nproc_per_node N -m egonerf_torch
...`` each process joins the launch's process group (NCCL) on
``cuda:LOCAL_RANK`` and training is data parallel over the N ranks
(``parallel/mesh.py``); the evaluation runs on the lead rank alone."""
import sys

from .train.config import parse_cli


def main(argv=None):
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    from .parallel.mesh import init_from_env, is_lead_process, rank_device
    from .train.trainer import Trainer, render_test

    dev = rank_device("cuda")
    init_from_env(dev)
    if not cfg.evaluation:
        Trainer(cfg, device=dev).train()
    elif is_lead_process():
        render_test(cfg, device=dev)


if __name__ == "__main__":
    main()
