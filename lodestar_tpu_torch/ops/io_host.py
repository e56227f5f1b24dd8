"""Host-side conversions between field elements and limb arrays.

The oracle tier (`bls/`) speaks Python ints; the tensor tier speaks
(..., 32) int32 Montgomery limbs. These helpers cross that boundary on
the host, as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from ..bls.fields import Fq, Fq2
from .limbs import fp_from_mont_host, fp_to_mont_host


def fq_to_limbs(x: Fq) -> np.ndarray:
    return fp_to_mont_host(x.n)


def limbs_to_fq(a) -> Fq:
    return Fq(fp_from_mont_host(np.asarray(a)))


def fq2_to_limbs(x: Fq2) -> np.ndarray:
    return np.stack([fp_to_mont_host(x.c0.n), fp_to_mont_host(x.c1.n)])


def limbs_to_fq2(a) -> Fq2:
    a = np.asarray(a)
    return Fq2(limbs_to_fq(a[0]), limbs_to_fq(a[1]))
