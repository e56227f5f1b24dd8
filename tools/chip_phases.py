"""Run some of `chip_smoke.py`'s chain-family phases alone on one GPU.

    python3 tools/chip_phases.py [chain] [network] [capella] [cli] [rest]

Always runs env, build and block_import (their stack and scenario feed
the rest), then the phases named, in the script's order (network needs
chain; with no name, all five), every check as `chip_smoke.py` makes it.
`cli` (the port's CLI as a subprocess on the card: a `beacon` node, a
posted block, then a `validator` subprocess whose two proposals the node
imports, its keymanager, and the `flare` commands' slashings) and `rest`
(the two-node simulation on the card, the light client and the spec-test
harness) run last, after the stack is closed.
Prints the phases' `[time]` lines and one `[phases]` line with the
seconds of each and the card; writes the records to
`build/lodestar_tpu_torch/chip_phases.json`. Exits non-zero when a check
fails.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ORDER = ("chain", "network", "capella", "cli", "rest")


def main(argv) -> int:
    import numpy as np
    import torch

    want = [p for p in ORDER if p in argv] or list(ORDER)
    if "network" in want and "chain" not in want:
        want.insert(0, "chain")
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    cs.phase_env(torch)
    torch.cuda.init()
    cs.timed("build", cs.phase_build)
    _, stack, scenario, jobs = cs.timed("block_import", cs.phase_block_import, torch, np)
    out = {}
    try:
        if "chain" in want:
            out["chain"] = cs.timed("chain", cs.phase_chain, torch, np, stack, scenario, jobs)
        if "network" in want:
            out["network"] = cs.timed("network", cs.phase_network, torch, np, stack, scenario,
                                      jobs, out["chain"])
        elif "chain" in out:
            out["chain"].pop("chain").close()
        if "capella" in want:
            out["capella"] = cs.timed("capella", cs.phase_capella, torch, np, stack, scenario,
                                      jobs)
    finally:
        stack.close()
    if "cli" in want:
        out["cli"] = cs.timed("cli", cs.phase_cli, torch, np)
    if "rest" in want:
        out["rest"] = cs.timed("rest", cs.phase_rest, torch, np)
    cs.log(f"[phases] {json.dumps({k: round(v, 1) for k, v in cs.PHASE_SECONDS.items()})}; "
           f"{time.perf_counter() - t0:.1f} s; card: {cs.card_line()}")
    out_dir = os.path.join(ROOT, "build", "lodestar_tpu_torch")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_phases.json"), "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items() if kk not in ("chain", "gossip")}
                   for k, v in out.items()}, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
