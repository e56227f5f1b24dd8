"""Base-field Fp arithmetic on int32 limb tensors.

Montgomery-form arithmetic over p (BLS12-381) in the 32×12-bit limb
layout of `limbs.py`. Plain PyTorch functions, broadcasting over leading
batch axes with the limb axis last; each runs on the device of its
inputs. Values range over [0, 2p) between operations (lazy reduction) and
`canonical` gives the < p form.

Every function here computes the same limbs as its namesake in the JAX
package's `ops/fp.py`. Where that module runs a 32-step scan for a carry,
this one uses fewer, wider tensor operations (folds plus a carry
look-ahead), which give the same limbs and the same final carry for any
input. The Montgomery product `mul` goes to `cuda_mxu.mont_mul`: a
hand-written kernel on a CUDA tensor (K4 from 4096 products up, K1 below),
its plain version on a CPU tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..bls.fields import P as _P_INT
from .limbs import (
    LIMB_BITS,
    LIMB_MASK,
    N_LIMBS,
    ONE_MONT_LIMBS,
    P_LIMBS,
    R2_LIMBS,
    TWO_P_LIMBS,
)

I32 = torch.int32

FOUR_P2_COLS = np.asarray(
    [(4 * _P_INT * _P_INT >> (12 * i)) & 0xFFF for i in range(64)], np.int32
)
EIGHT_P2_COLS = np.asarray(
    [(8 * _P_INT * _P_INT >> (12 * i)) & 0xFFF for i in range(64)], np.int32
)
_ONE_LIMBS = np.eye(1, N_LIMBS, dtype=np.int32)[0]  # the integer 1

_CONSTS: dict = {}


def const(arr: np.ndarray, device) -> torch.Tensor:
    """A module-level numpy constant as a tensor on `device` (cached; the
    arrays live as long as their modules, so their ids are stable)."""
    key = (id(arr), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(arr).to(device)
        _CONSTS[key] = t
    return t


def broadcast_shapes(*shapes) -> tuple:
    """numpy broadcasting of shapes (the PyTorch helper of the same name
    costs more than the tensor ops it precedes at small widths)."""
    ndim = max(len(s) for s in shapes)
    out = [1] * ndim
    for s in shapes:
        for i, d in enumerate(s, ndim - len(s)):
            if d != 1:
                if out[i] not in (1, d):
                    raise ValueError(f"shapes {shapes} do not broadcast")
                out[i] = d
    return tuple(out)


def two_p(like: torch.Tensor) -> torch.Tensor:
    """2p as limbs on `like`'s device (the bias of subtraction columns)."""
    return const(TWO_P_LIMBS, like.device)


def _shift_up(c: torch.Tensor) -> torch.Tensor:
    """Column i of the result is c[i − 1]; column 0 is zero."""
    return torch.nn.functional.pad(c[..., :-1], (1, 0))


def _look_ahead(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """Binary carry look-ahead: returns the carry OUT of every column,
    where column i generates when gen[i], passes its carry in when
    prop[i], and kills it otherwise (the carry into column 0 is 0).

    The carry out of column i is gen[j] at the last column j ≤ i that
    does not propagate (0 if there is none): one cummax over indices."""
    k = gen.shape[-1]
    idx = torch.arange(k, device=gen.device).expand(gen.shape)
    last = torch.cummax(torch.where(prop, -1, idx), dim=-1).values
    got = torch.gather(gen, -1, last.clamp(min=0))
    return (got & (last >= 0)).to(torch.int8)


def _carry_scan_out(t: torch.Tensor, bits: int = LIMB_BITS):
    """Exact carry/borrow propagation of signed columns of `bits`-bit
    weight (int32 with |t| < 2^31, or int64 with |t| < 2^62 for 24-bit
    digits) → (canonical digits, final carry), in t's dtype.

    The digits are value mod 2^(bits·k) and the final carry is
    floor(value / 2^(bits·k)), as the JAX package's sequential scan
    gives them (−1 for a small negative value: callers use it as a sign
    probe). Three shift-folds bring the digits to [−1, 2^bits]; the value
    is then split as D − N (D's digits in [0, 2^bits], N's in {0, 1}), D
    is normalised with a carry look-ahead and N subtracted with a borrow
    look-ahead."""
    mask = (1 << bits) - 1
    x = t
    top = torch.zeros_like(t[..., 0])
    for _ in range(3):
        c = x >> bits
        top = top + c[..., -1]
        x = (x & mask) + _shift_up(c)
    pos = x.clamp(min=0)
    carry = _look_ahead(pos > mask, pos == mask)
    e = ((pos + _shift_up(carry)) & mask) - (x < 0).to(x.dtype)
    borrow = _look_ahead(e < 0, e == 0)
    digits = (e - _shift_up(borrow)) & mask
    return digits, top + carry[..., -1] - borrow[..., -1]


def carry_scan(t: torch.Tensor) -> torch.Tensor:
    """Carry/borrow propagation → canonical 12-bit limbs; the final carry
    is dropped (callers guarantee a non-negative value that fits)."""
    return _carry_scan_out(t)[0]


def _lex_ge(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a >= m comparing canonical limb vectors: the sign of a − m."""
    return _carry_scan_out(a - m)[1] >= 0


def _cond_sub_cols(cols: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Canonical limbs of v − m if v ≥ m else v, for SIGNED columns of a
    value 0 ≤ v < 2^384 and m canonical: one stacked carry over both
    candidates, selected by the borrow of the v − m lane."""
    cols, m = torch.broadcast_tensors(cols, m)
    limbs, out = _carry_scan_out(torch.stack([cols, cols - m]))
    return torch.where((out[1] < 0)[..., None], limbs[0], limbs[1])


def _cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _cond_sub_cols(a, m)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _cond_sub_cols(a + b, two_p(a))


def reduce_sums(cols: torch.Tensor) -> torch.Tensor:
    """[0, 2p) limbs from SIGNED column expressions with value in [0, 4p)
    (`a + b`, `a − b + 2p`): one shared carry for a whole stage."""
    return _cond_sub_cols(cols, two_p(cols))


class Sum:
    """Bounds-tracked column expression: signed limb columns whose VALUE
    lies in [lo, hi) (units of 2p), tracked through +/−, for
    `reduce_stack`."""

    __slots__ = ("cols", "lo", "hi")

    def __init__(self, cols, lo, hi):
        self.cols = cols
        self.lo = lo
        self.hi = hi

    def __add__(self, o):
        return Sum(self.cols + o.cols, self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o):
        return Sum(self.cols - o.cols, self.lo - o.hi, self.hi - o.lo)

    def double(self):
        return Sum(self.cols + self.cols, 2 * self.lo, 2 * self.hi)


def wrap(cols) -> Sum:
    """[0, 2p) limbs as a Sum (lo = 0, hi = 1 in 2p units)."""
    return Sum(cols, 0, 1)


_MULTIPLES: dict = {}


def _two_p_multiples(k: int) -> np.ndarray:
    """(k, 32) int32 columns i·2p for i < k, as limb-wise multiples."""
    arr = _MULTIPLES.get(k)
    if arr is None:
        arr = np.arange(k, dtype=np.int32)[:, None] * TWO_P_LIMBS[None, :]
        _MULTIPLES[k] = arr
    return arr


def reduce_stack(sums: "list[Sum]") -> "list[torch.Tensor]":
    """[0, 2p) limbs for every Sum with ONE shared carry.

    Each expression is biased by its own multiple of 2p to make it
    non-negative, then reduced by choosing among its k candidates
    v − i·2p the last one whose final carry is non-negative (the
    candidates decrease, so that is the count of non-negative ones − 1)."""
    shape = broadcast_shapes(*(s.cols.shape for s in sums))
    device = sums[0].cols.device
    tp = const(TWO_P_LIMBS, device)
    blocks, spans = [], []
    start = 0
    for s in sums:
        bias = max(0, -math.floor(s.lo))
        k = max(1, math.ceil(s.hi + bias))  # value < k·2p after biasing
        base = torch.broadcast_to(s.cols + bias * tp, shape)
        offs = const(_two_p_multiples(k), device)
        blocks.append(base[None] - offs.view((k,) + (1,) * (len(shape) - 1) + (N_LIMBS,)))
        spans.append((start, k))
        start += k
    limbs, out = _carry_scan_out(torch.cat(blocks))
    results = []
    for start, k in spans:
        if k == 1:
            results.append(limbs[start])
            continue
        pick = ((out[start : start + k] >= 0).sum(0, dtype=I32) - 1).clamp(min=0)
        idx = pick[None, ..., None].expand((1,) + shape)
        results.append(torch.gather(limbs[start : start + k], 0, idx)[0])
    return results


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    tp = two_p(a)
    return _cond_sub_cols(a - b + tp, tp)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def double(a: torch.Tensor) -> torch.Tensor:
    return add(a, a)


# --- column-space (lazy-reduction) pipeline ---------------------------------
#
# Products as 64 uncarried int32 columns let tower code add and subtract
# whole products before reducing (Fp2 Karatsuba as 3 convolutions + 2
# REDCs). One product of canonical-limb inputs stays < 2^29 per column.


def conv_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook convolution → (..., 2N) int32 columns: column k is
    Σ_i a_i·b_{k−i}, as one product against a Toeplitz view of b."""
    batch = broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a = torch.broadcast_to(a, batch + (N_LIMBS,))
    b = torch.broadcast_to(b, batch + (N_LIMBS,))
    bz = torch.nn.functional.pad(b, (N_LIMBS - 1, N_LIMBS))
    win = bz.unfold(-1, N_LIMBS, 1)  # (..., 64, 32): win[k][j] = b[k + j − 31]
    return (win * torch.flip(a, (-1,))[..., None, :]).sum(-1, dtype=I32)


# the REDC below runs on 24-bit digits in int64: half the sequential steps
_P24 = np.asarray([(_P_INT >> (24 * i)) & 0xFFFFFF for i in range(16)], np.int64)
_N0_24 = (-pow(_P_INT, -1, 1 << 24)) % (1 << 24)
_MASK24 = (1 << 24) - 1


def _redc(t: torch.Tensor) -> torch.Tensor:
    """Montgomery reduction of (..., 2N) signed, uncarried int32 columns
    of a NON-NEGATIVE value T < 2^768 → canonical limbs of (T + M·p)/R,
    M = (−T·p⁻¹) mod R, without a final subtraction.

    The JAX package's `_redc_scan` kills one 12-bit limb per step; this
    kills one 24-bit digit per step (int64 columns: 16 products of
    < 2^48 plus the input stay < 2^53), then carries. M and so the result
    depend only on T's value, so the limbs are the same."""
    t24 = t[..., 0::2].long() + (t[..., 1::2].long() << LIMB_BITS)
    p24 = const(_P24, t.device)
    for j in range(16):
        m = ((t24[..., j] & _MASK24) * _N0_24) & _MASK24
        t24[..., j : j + 16].addcmul_(m[..., None], p24)
        t24[..., j + 1] += t24[..., j] >> 24
    d24, _ = _carry_scan_out(t24[..., 16:], 24)
    limbs = torch.stack([d24 & LIMB_MASK, d24 >> LIMB_BITS], dim=-1)
    return limbs.reshape(t.shape[:-1] + (N_LIMBS,)).to(I32)


def redc_cols(t_cols: torch.Tensor) -> torch.Tensor:
    """Montgomery-reduce signed columns of a NON-NEGATIVE value < 12p² →
    limbs in [0, 2p): (t + m·p)/R < 2.51p, so one conditional
    2p-subtract restores the contract."""
    return _cond_sub(_redc(t_cols), two_p(t_cols))


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product REDC(a·b): inputs < 2p, output < 2p.

    Always `cuda_mxu.mont_mul`, the JAX package's MXU configuration
    (`LODESTAR_TPU_PALLAS_MXU=1`, which takes precedence over its
    `LODESTAR_TPU_PALLAS_MUL` route): a call of at least 4096 flattened
    products runs K4, the integer-tensor-core kernel, and a smaller one K1,
    which stands in for the word-serial `_mul_scan` the JAX path gives way
    to (limb for limb the same). On CPU tensors both are their plain
    versions."""
    from .cuda_mxu import mont_mul

    return mont_mul(a, b)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Normal-domain canonical limbs → Montgomery form."""
    return mul(a, const(R2_LIMBS, a.device))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form → canonical normal-domain limbs (< p)."""
    return _cond_sub(mul(a, const(_ONE_LIMBS, a.device)), const(P_LIMBS, a.device))


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Reduce the [0, 2p) representative to the unique [0, p) form."""
    return _cond_sub(a, const(P_LIMBS, a.device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == 0, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canonical(a) == canonical(b), dim=-1)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b, broadcasting cond over the limb axis."""
    return torch.where(cond[..., None], a, b)


def zero(batch: tuple = (), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch) + (N_LIMBS,), dtype=I32, device=device)


def one_mont(batch: tuple = (), device=None) -> torch.Tensor:
    return const(ONE_MONT_LIMBS, device).expand(tuple(batch) + (N_LIMBS,))


# the multiplicative identity in the working (Montgomery) representation,
# under the name CurveOps expects of a field module
one = one_mont


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a static exponent: square-and-multiply over its bits, MSB
    first (a multiply only where the bit is set)."""
    if e == 0:
        return one_mont(a.shape[:-1], a.device)
    acc = a
    for bit in bin(e)[3:]:
        acc = square(acc)
        if bit == "1":
            acc = mul(acc, a)
    return acc


def inv(a: torch.Tensor) -> torch.Tensor:
    """Fermat inverse a^(p−2); 0 maps to 0."""
    return pow_const(a, _P_INT - 2)


def sqrt_candidate(a: torch.Tensor) -> torch.Tensor:
    """a^((p+1)/4): a square root iff a is a QR (p ≡ 3 mod 4)."""
    return pow_const(a, (_P_INT + 1) // 4)
