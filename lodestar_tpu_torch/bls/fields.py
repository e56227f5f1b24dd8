"""BLS12-381 base field and its quadratic extension over Python ints.

The port's own copy of the oracle arithmetic that its constant tables are
built from (the Frobenius γ values, the ψ coefficients, the generators).
Host-only and slow by design; nothing here touches a tensor.

Tower: Fq2 = Fq[u]/(u² + 1), Fq6 = Fq2[v]/(v³ − ξ), Fq12 = Fq6[w]/(w² − v),
ξ = 1 + u.
"""

from __future__ import annotations

# Base field modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
# Subgroup order
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
# BLS parameter x (negative): p and r are polynomials in x.
X_PARAM = -0xD201000000010000


class Fq:
    """Prime field element (immutable)."""

    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, other: "Fq") -> "Fq":
        return Fq(self.n + other.n)

    def __sub__(self, other: "Fq") -> "Fq":
        return Fq(self.n - other.n)

    def __mul__(self, other: "Fq") -> "Fq":
        return Fq(self.n * other.n)

    def __neg__(self) -> "Fq":
        return Fq(-self.n)

    def inverse(self) -> "Fq":
        if self.n == 0:
            raise ZeroDivisionError("Fq inverse of 0")
        return Fq(pow(self.n, P - 2, P))

    def is_zero(self) -> bool:
        return self.n == 0

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fq) and self.n == other.n

    def __hash__(self) -> int:
        return hash(("Fq", self.n))

    def __repr__(self) -> str:
        return f"Fq(0x{self.n:x})"

    @staticmethod
    def zero() -> "Fq":
        return Fq(0)

    @staticmethod
    def one() -> "Fq":
        return Fq(1)


class Fq2:
    """Fq[u]/(u²+1): c0 + c1·u."""

    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq, c1: Fq):
        self.c0 = c0
        self.c1 = c1

    @staticmethod
    def from_ints(a: int, b: int) -> "Fq2":
        return Fq2(Fq(a), Fq(b))

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        t0 = self.c0 * o.c0
        t1 = self.c1 * o.c1
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fq2(t0 - t1, t2 - t0 - t1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inverse(self) -> "Fq2":
        inv_norm = (self.c0 * self.c0 + self.c1 * self.c1).inverse()
        return Fq2(self.c0 * inv_norm, -(self.c1 * inv_norm))

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e > 0:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero()

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Fq2) and self.c0 == other.c0 and self.c1 == other.c1

    def __hash__(self) -> int:
        return hash(("Fq2", self.c0.n, self.c1.n))

    def __repr__(self) -> str:
        return f"Fq2(0x{self.c0.n:x}, 0x{self.c1.n:x})"

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(Fq(0), Fq(0))

    @staticmethod
    def one() -> "Fq2":
        return Fq2(Fq(1), Fq(0))


# ξ = 1 + u: the Fq6/Fq12 non-residue
XI = Fq2.from_ints(1, 1)


def _compute_frob_gammas() -> dict[int, list[Fq2]]:
    """γ_i^(k) = ξ^(i(p^k−1)/6) for k in 1..3, i in 0..5."""
    out: dict[int, list[Fq2]] = {}
    for k in (1, 2, 3):
        base = XI.pow((P**k - 1) // 6)
        gammas = [Fq2.one()]
        for _ in range(5):
            gammas.append(gammas[-1] * base)
        out[k] = gammas
    return out


FROB_GAMMA = _compute_frob_gammas()
