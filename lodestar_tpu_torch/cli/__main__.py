"""`python -m lodestar_tpu_torch.cli` — command dispatcher (reference:
cli/src/cli.ts yargs tree)."""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..utils.logger import FORMAT, TraceContextFilter
from .beacon import add_beacon_parser
from .dev import add_dev_parser
from .flare import add_flare_parser
from .lightclient import add_lightclient_parser
from .validator import add_validator_parser


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="lodestar-tpu-torch", description="beacon node on the PyTorch/CUDA port"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    add_dev_parser(sub)
    add_beacon_parser(sub)
    add_validator_parser(sub)
    add_lightclient_parser(sub)
    add_flare_parser(sub)
    args = parser.parse_args(argv)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(FORMAT, datefmt="%H:%M:%S"))
    handler.addFilter(TraceContextFilter())
    logging.basicConfig(level=logging.INFO, handlers=[handler])
    return args.func(args)


if __name__ == "__main__":
    rc = main()
    # leave without interpreter teardown: a verdict the supervisor
    # abandoned past its deadline may still be running on a daemon thread
    # inside PyTorch, whose thread pools abort the process if torn down
    # under it; everything the commands persist is closed by now
    logging.shutdown()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc if isinstance(rc, int) else 1)
