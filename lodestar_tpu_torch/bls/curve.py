"""BLS12-381 G1/G2 host arithmetic over Python ints (constants only).

E1: y² = x³ + 4 over Fq; E2: y² = x³ + 4(1+u) over Fq2. Jacobian
coordinates; just enough group law to build the device constant tables
(the generators, the −[2^b]·g1 table) and the ψ coefficients.
"""

from __future__ import annotations

from .fields import P, Fq, Fq2, XI

G1_X = Fq(
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
)
G1_Y = Fq(
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
)
G2_X = Fq2(
    Fq(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8),
    Fq(0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
)
G2_Y = Fq2(
    Fq(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801),
    Fq(0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
)


class Point:
    """Jacobian point (X, Y, Z) over Fq or Fq2; Z = 0 is infinity."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x, y, z):
        self.x, self.y, self.z = x, y, z

    def is_infinity(self) -> bool:
        return self.z.is_zero()

    def to_affine(self):
        if self.is_infinity():
            return None
        zinv = self.z.inverse()
        zinv2 = zinv * zinv
        return (self.x * zinv2, self.y * zinv2 * zinv)

    def double(self) -> "Point":
        if self.is_infinity():
            return self
        X1, Y1, Z1 = self.x, self.y, self.z
        A = X1 * X1
        B = Y1 * Y1
        C = B * B
        t = X1 + B
        D = t * t - A - C
        D = D + D
        E = A + A + A
        X3 = E * E - (D + D)
        eight_c = C + C
        eight_c = eight_c + eight_c
        eight_c = eight_c + eight_c
        Y3 = E * (D - X3) - eight_c
        Z3 = (Y1 + Y1) * Z1
        return type(self)(X3, Y3, Z3)


class PointG1(Point):
    __slots__ = ()

    @staticmethod
    def generator() -> "PointG1":
        return PointG1(G1_X, G1_Y, Fq.one())


class PointG2(Point):
    __slots__ = ()

    @staticmethod
    def generator() -> "PointG2":
        return PointG2(G2_X, G2_Y, Fq2.one())


# ψ(x, y) = (conj(x)·cx, conj(y)·cy): untwist, Frobenius, retwist, with
# cx = 1/ξ^((p−1)/3) and cy = 1/ξ^((p−1)/2).
PSI_CX = XI.pow((P - 1) // 3).inverse()
PSI_CY = XI.pow((P - 1) // 2).inverse()
