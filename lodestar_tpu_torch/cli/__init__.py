"""CLI: `python -m lodestar_tpu_torch.cli <cmd>`.

Reference: `packages/cli` yargs commands. The port's copy of the JAX
package's `cli/`, with the `beacon` command: a beacon node whose
signature verdicts run on the GPU (`--device cuda`, the default) or on
the kernels' plain versions (`--device cpu`); `validator`, a validator
client over a beacon node's REST API; `dev`, a single-process local
testnet whose chain verifies on `--device` likewise; `lightclient`, a
light client following a node's Beacon API; and `flare`, which submits
self-slashings of interop keys to a node.
"""
