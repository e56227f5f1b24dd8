"""lodestar_tpu_torch: the BLS12-381 batch verifier in PyTorch and CUDA.

The port of `lodestar_tpu`'s device tier to an NVIDIA H100: the same
int32 limb layout and the same functions, as plain PyTorch, with the JAX
package's four Pallas kernels as hand-written sm_90a kernels: the
Montgomery multiply on the CUDA cores (`ops/cuda_fp.py`) and on the
integer tensor cores (`ops/cuda_mxu.py`), the Miller loop and the fused
per-set pairing (`ops/cuda_tower.py`).
It imports neither JAX nor `lodestar_tpu`. The entry points are
`parallel.verifier.TorchBlsVerifier` and the serving facade over it,
`chain.bls_verifier.DeviceBlsVerifier`, and the serving stack a node
composes over it, `node.bls_stack.build_bls_stack`; they run on the GPU
unless the caller passes `device="cpu"`.

Beside the device tier sits block import's producer side, on the host:
`params`, `config`, `ssz`, `types` and the phase0/Altair
`state_transition`, whose signature sets the stack verifies
(`profile_block`).
"""
