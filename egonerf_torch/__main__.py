"""Command line: ``python -m egonerf_torch --config configs/....txt [--key value]``
trains on the card; ``--evaluation 1`` renders the test set from the newest
checkpoint and prints its PSNR (counterpart of ``egonerf_tpu/__main__.py``)."""
import sys

from .train.config import parse_cli


def main(argv=None):
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    from .train.trainer import Trainer, render_test

    if cfg.evaluation:
        render_test(cfg)
    else:
        Trainer(cfg).train()


if __name__ == "__main__":
    main()
