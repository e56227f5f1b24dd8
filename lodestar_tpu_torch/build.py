"""Build the port's shared libraries from the sources in the checkout.

Each library is compiled at first use into `build/lodestar_tpu_torch/` at
the repository root (listed in `.gitignore`). The file name carries a
hash of the sources, the headers and the command, so an edited source is
rebuilt and an unchanged one is reused; a file lock makes parallel test
workers build once. Libraries have a plain C interface and are loaded
with `ctypes` (no Python or PyTorch headers, so a build takes seconds).

- `host_tier()`: the C host tier (BLS12-381 decompression, hash-to-curve,
  signing, CPU verification) with `cc`.
- `mont_mul_host()`: the K1 arithmetic headers (`fp_mont.cuh`'s
  one-thread CIOS, `fp_mont_group.cuh`'s half-warp product with its
  shuffles emulated) built for the host with `c++`, for the CPU tests.
- `mont_mul_cuda()`: kernel K1 for sm_90a with `nvcc`; `BUILD_LOG["mont_mul"]`
  keeps ptxas's figures.
- `tower_host()`: the K2/K3 arithmetic headers (`tower.cuh`, and
  `tower_warp.cuh` and `miller_warp.cuh` with their warp emulated) built
  for the host with `c++`, for the CPU tests and the kernels' operation
  and round counts.
- `tower_cuda()`: kernels K2, K2p, K3 and K3-fe (`tower.cu`) for sm_90a with `nvcc`;
  `BUILD_LOG["tower"]` keeps ptxas's registers, stack and spills.
- `fe_probe_cuda()`: a probe of K3-fe's schedule (`fe_probe.cu`: cycles
  by operation on one lane) for sm_90a with `nvcc`; not on the port's
  path, built only by `python3 -m lodestar_tpu_torch.profile_fe`.
- `mxu_host()`: the K4 arithmetic header (`mxu_mont.cuh`) built for the
  host with `c++`, its MMA emulated, for the CPU tests.
- `mxu_cuda()`: kernel K4 (`mxu_mont.cu`) for sm_90a with `nvcc`;
  `BUILD_LOG["mxu_mont"]` keeps ptxas's figures.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "lodestar_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# name -> (seconds the last build took, compiler output); empty until built
BUILD_LOG: dict[str, tuple[float, str]] = {}


class BuildError(RuntimeError):
    pass


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def find_compiler(*names: str) -> str | None:
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    return None


def _digest(cmd: list[str], files: list[str]) -> str:
    h = hashlib.sha256("\0".join(cmd).encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_shared(name: str, compiler: str | None, flags: list[str],
                 sources: list[str], headers: list[str] = ()) -> str:
    """Compile `sources` (paths under csrc/) into lib<name>-<hash>.so and
    return its path; raises BuildError when there is no compiler or the
    compiler fails. Each call is one event of the compile ledger (kernel
    `build/<name>`, key the digest): `hit` when the library was already
    built, `miss` when it was compiled now."""
    from .observability import compile_ledger, flight_recorder

    if compiler is None:
        raise BuildError(f"{name}: no compiler found")
    t0 = time.monotonic()
    srcs = [os.path.join(CSRC, s) for s in sources]
    deps = srcs + [os.path.join(CSRC, h) for h in headers]
    cmd = [os.path.basename(compiler)] + list(flags)
    digest = _digest(cmd, deps)
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    kernel = f"build/{name}"
    if os.path.exists(out):
        compile_ledger.ledger().record(kernel, digest, time.monotonic() - t0, "hit")
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):  # another process built it meanwhile
            compile_ledger.ledger().record(kernel, digest, time.monotonic() - t0, "hit")
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        flight_recorder.record("compile_start", kernel=kernel, key=digest)
        t1 = time.monotonic()
        proc = subprocess.run(
            [compiler] + list(flags) + ["-I", CSRC, "-o", tmp] + srcs,
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise BuildError(f"{name}: build failed\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        BUILD_LOG[name] = (time.monotonic() - t1, proc.stdout + proc.stderr)
    compile_ledger.ledger().record(kernel, digest, time.monotonic() - t0, "miss")
    return out


_LIBS: dict[str, ctypes.CDLL] = {}


def _load(name: str, build) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(build())
        _LIBS[name] = lib
    return lib


def host_tier() -> ctypes.CDLL:
    return _load("bls12_host", lambda: build_shared(
        "bls12_host", find_compiler("cc", "gcc", "clang"),
        ["-O2", "-shared", "-fPIC"],
        ["host/bls12.c", "host/sha256.c"], ["host/bls12_consts.h"],
    ))


MONT_MUL_HEADERS = ["fp_mont.cuh", "fp_mont_group.cuh"]


def mont_mul_host() -> ctypes.CDLL:
    return _load("mont_mul_host", lambda: build_shared(
        "mont_mul_host", find_compiler("c++", "g++", "clang++"),
        ["-O2", "-std=c++17", "-shared", "-fPIC"],
        ["mont_mul_host.cpp"], MONT_MUL_HEADERS,
    ))


def mont_mul_cuda() -> ctypes.CDLL:
    return _load("mont_mul", lambda: build_shared(
        "mont_mul", find_nvcc(), NVCC_FLAGS, ["mont_mul.cu"], MONT_MUL_HEADERS,
    ))


TOWER_HEADERS = ["tower.cuh", "tower_warp.cuh", "miller_warp.cuh", "miller_sched.cuh",
                 "tower_consts.cuh", "fp_mont.cuh"]


def tower_host() -> ctypes.CDLL:
    return _load("tower_host", lambda: build_shared(
        "tower_host", find_compiler("c++", "g++", "clang++"),
        ["-O2", "-std=c++17", "-shared", "-fPIC"],
        ["tower_host.cpp"], TOWER_HEADERS,
    ))


def tower_cuda() -> ctypes.CDLL:
    return _load("tower", lambda: build_shared(
        "tower", find_nvcc(), NVCC_FLAGS, ["tower.cu"], TOWER_HEADERS,
    ))


def fe_probe_cuda() -> ctypes.CDLL:
    return _load("fe_probe", lambda: build_shared(
        "fe_probe", find_nvcc(), NVCC_FLAGS, ["fe_probe.cu"], TOWER_HEADERS,
    ))


MXU_HEADERS = ["mxu_mont.cuh", "fp_mont.cuh"]


def mxu_host() -> ctypes.CDLL:
    return _load("mxu_mont_host", lambda: build_shared(
        "mxu_mont_host", find_compiler("c++", "g++", "clang++"),
        ["-O2", "-std=c++17", "-shared", "-fPIC"],
        ["mxu_mont_host.cpp"], MXU_HEADERS,
    ))


def mxu_cuda() -> ctypes.CDLL:
    return _load("mxu_mont", lambda: build_shared(
        "mxu_mont", find_nvcc(), NVCC_FLAGS, ["mxu_mont.cu"], MXU_HEADERS,
    ))


def ptxas_summary(text: str) -> dict[str, dict[str, int]]:
    """Per-function figures from `nvcc -Xptxas -v` output: registers and
    static shared memory (entry functions), stack frame, cumulative stack
    (entries that make calls), spill stores and loads, in bytes. Keys are
    the mangled names."""
    out: dict[str, dict[str, int]] = {}
    current = entry = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})["entry"] = 1
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            c = re.search(r"(\d+) bytes cumulative stack size", line)
            if c:
                out[entry]["cumulative_stack"] = int(c.group(1))
            c = re.search(r"(\d+) bytes smem", line)
            if c:
                out[entry]["smem"] = int(c.group(1))
    return out

