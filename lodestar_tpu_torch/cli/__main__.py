"""`python -m lodestar_tpu_torch.cli` — command dispatcher (reference:
cli/src/cli.ts yargs tree)."""

from __future__ import annotations

import argparse
import logging
import sys

from .beacon import add_beacon_parser

_FORMAT = "%(asctime)s %(levelname)-5s [%(name)s] %(message)s"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="lodestar-tpu-torch", description="beacon node on the PyTorch/CUDA port"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    add_beacon_parser(sub)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format=_FORMAT, datefmt="%H:%M:%S",
                        stream=sys.stderr)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
