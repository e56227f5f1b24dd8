"""Generate `csrc/tower_consts.cuh`, the constants of the tower kernels.

    python3 -m lodestar_tpu_torch.gen_tower_consts > lodestar_tpu_torch/csrc/tower_consts.cuh

The constants come from the port's own oracle arithmetic (`bls/fields.py`,
`bls/curve.py`) through the limb helpers, so the kernels close over the
very values the plain PyTorch tower uses. Each is written as literal
assignments to 32-bit words (little-endian) inside a function, as
`fp_mont.cuh` writes p: both compilers keep them in immediates and no
table lives in device memory. `tests/test_torch_tower_kernels.py` holds
the committed header equal to this script's output.
"""

from __future__ import annotations

from .bls import curve
from .bls.fields import FROB_GAMMA, P, Fq2
from .ops.limbs import fp_to_mont_host, limbs_to_int

N_WORDS = 12


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(N_WORDS)]


def _mont(x: int) -> list[int]:
    return _words(limbs_to_int(fp_to_mont_host(x % P)))


def _assign(name: str, words: list[int], indent: str = "  ") -> str:
    return "\n".join(f"{indent}{name}[{i}] = 0x{w:08x}u;" for i, w in enumerate(words))


def _fn(name: str, args: str, body: str) -> str:
    return f"TW_INL void {name}({args}) {{\n{body}\n}}\n"


def constants() -> dict[str, object]:
    """The tables the header carries, as 32-bit word lists."""
    gen = curve.PointG1.generator().to_affine()
    b3 = Fq2.from_ints(12, 12)  # 3·b' = 3·4(1 + u), the twist's b3
    gamma = [[(_mont(g.c0.n), _mont(g.c1.n)) for g in FROB_GAMMA[k]] for k in (1, 2, 3)]
    return {
        "one": _mont(1),
        "b3": (_mont(b3.c0.n), _mont(b3.c1.n)),
        "g1_x": _mont(gen[0].n),
        "g1_neg_y": _mont((-gen[1]).n),
        "p_minus_2": _words(P - 2),
        "r3": _words(pow(2, 3 * 384, P)),
        "gamma": gamma,
    }


def render() -> str:
    c = constants()
    parts = [
        "// Constants of the tower kernels (tower.cuh): Montgomery form with",
        "// R = 2^384 unless noted, as 12 little-endian 32-bit words.",
        "// Generated by `python3 -m lodestar_tpu_torch.gen_tower_consts`; do not edit.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace tw {",
        "namespace consts {",
        "",
        "// 1",
        _fn("one", "uint32_t w[12]", _assign("w", c["one"])),
        "// 3*b' = 12 + 12u, the twist's b3",
        _fn("b3", "uint32_t c0[12], uint32_t c1[12]",
            _assign("c0", c["b3"][0]) + "\n" + _assign("c1", c["b3"][1])),
        "// the affine G1 generator's x and -y",
        _fn("g1_x", "uint32_t w[12]", _assign("w", c["g1_x"])),
        _fn("g1_neg_y", "uint32_t w[12]", _assign("w", c["g1_neg_y"])),
        "// p - 2, a plain integer: the Fermat exponent of the Fp inverse",
        _fn("p_minus_2", "uint32_t w[12]", _assign("w", c["p_minus_2"])),
        "// R^3 mod p, a plain integer: one Montgomery multiply by it turns the",
        "// plain inverse (aR)^-1 of a Montgomery value aR into a^-1 R",
        _fn("r3", "uint32_t w[12]", _assign("w", c["r3"])),
    ]
    cases = []
    for k in range(3):
        for i in range(6):
            c0, c1 = c["gamma"][k][i]
            body = _assign("c0", c0, "      ") + "\n" + _assign("c1", c1, "      ")
            cases.append(f"    case {6 * k + i}:\n{body}\n      break;")
    parts += [
        "// gamma_i^(k) = xi^(i (p^k - 1) / 6), k = 1..3, i = 0..5: the Frobenius",
        "// coefficients of the w-basis (bls/fields.py FROB_GAMMA)",
        "TW_FN void gamma(uint32_t c0[12], uint32_t c1[12], int k, int i) {",
        "  switch (6 * (k - 1) + i) {",
        *cases,
        "    default:",
        "      for (int j = 0; j < 12; j++) c0[j] = c1[j] = 0;",
        "  }",
        "}",
        "",
        "// the same gamma_i^(k) as one table of words, [k - 1][i][c0, c1][word], for",
        "// code that indexes them at run time (tower_warp.cuh)",
        "#define TW_GAMMA_WORDS \\",
        "  { \\",
        *[f"    {', '.join(f'0x{w:08x}u' for w in c['gamma'][k][i][h])}, \\"
          for k in range(3) for i in range(6) for h in range(2)],
        "  }",
        "",
        "}  // namespace consts",
        "}  // namespace tw",
        "",
    ]
    return "\n".join(parts)


if __name__ == "__main__":
    print(render(), end="")
