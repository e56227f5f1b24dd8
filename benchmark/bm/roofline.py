"""Work counts and peaks of the tower kernels' roofline, frozen here so that
the roofline reads the same work whatever implements it.

Per lane (per set for K3): the fewest Fp multiplies the function needs
(K2p's Miller loop 8,182; K3-fe's final exponentiation 7,724; K3's whole
set 22,020), each 576 int32 operations (2 · 12² word products, each a
mul.lo and a mul.hi) over 67 TOP/s, the H100 SXM's published
non-tensor 32-bit peak; and the bytes a lane reads and writes over
3.35 TB/s of HBM3. A launch's bound is the larger of the two times.

The lanes of a launch are read from its grid: one warp per lane (K2p,
K3-fe) or two per set (K3). Where the lanes do not fill the last block the
grid counts up to three lanes more than were asked for, at most 2 % of a
launch of more than 132 lanes (one lane per block below that).
"""

from __future__ import annotations

INT32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
OPS_PER_FP_MUL = 576

# name fragment -> (label, Fp multiplies per lane, bytes per lane, threads per lane)
KERNELS = {
    "miller_proj_warp_kernel": ("K2p", 8182, 4 * (3 * 32 + 3 * 64 + 384), 32),
    "final_exp_warp_kernel": ("K3-fe", 7724, 4 * (384 + 384), 32),
    "pairing_warp_kernel": ("K3", 22020, 4 * (32 + 32 + 4 * 64 + 384), 64),
}


def bound_s(fragment: str, lanes: int) -> float:
    _, muls, nbytes, _ = KERNELS[fragment]
    return max(muls * OPS_PER_FP_MUL * lanes / INT32_OPS_PER_S, nbytes * lanes / HBM_BYTES_PER_S)


def lanes_of(fragment: str, grid_block) -> int:
    grid, block = grid_block
    threads = grid[0] * grid[1] * grid[2] * block[0] * block[1] * block[2]
    return threads // KERNELS[fragment][3]


def share(sl) -> float | None:
    """Σ bound / Σ device time over the slice's launches of the tower
    kernels, in %; None when the slice holds none, or a launch's grid is
    unknown."""
    bound = spent = 0.0
    for fragment in KERNELS:
        for dur_ns, gb in sl.launches(fragment):
            if gb is None:
                return None
            bound += bound_s(fragment, lanes_of(fragment, gb))
            spent += dur_ns / 1e9
    return 100.0 * bound / spent if spent > 0 else None
