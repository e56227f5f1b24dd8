"""Build the port's shared libraries from the sources in the checkout.

Each library is compiled at first use into `build/lodestar_tpu_torch/` at
the repository root (listed in `.gitignore`), the ahead-of-time store of
`ops/aot_store.py`. The file name carries a digest of the sources, the
headers and the command, so an edited source is rebuilt and an unchanged
one is reused; its header carries the build's fingerprint (toolchain,
torch, card) and checksum, verified before the library is opened, so a
library of another toolchain or a damaged one is rebuilt instead; a file
lock makes parallel test workers build once. `LIBRARIES` lists every
library, `load(name)` opens one once per process. Libraries have a plain
C interface and are loaded with `ctypes` (no Python or PyTorch headers,
so a build takes seconds).

- `host_tier()`: the C host tier (BLS12-381 decompression, hash-to-curve,
  signing, CPU verification; SHA-256 levels; the network's snappy codec,
  xxHash64 and ChaCha20-Poly1305; the beacon database's KV engine,
  `kvstore.c`) with `cc`.
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
import sys
import threading
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


# the compile-ledger calls of builds made before the process loaded
# PyTorch (a process that only signs and hashes on the host tier, such as
# a validator or a light client, never does): `compile_ledger.ledger()`
# records them when it is first asked in a process that has PyTorch
PENDING_LEDGER: list[tuple[str, tuple, dict]] = []


class _PendingLedger:
    """The compile ledger's two calls, kept in `PENDING_LEDGER`."""

    def note_aot(self, *args, **kwargs) -> None:
        PENDING_LEDGER.append(("note_aot", args, kwargs))

    def record(self, *args, **kwargs) -> None:
        PENDING_LEDGER.append(("record", args, kwargs))


def _process_ledger():
    """The process-wide compile ledger once PyTorch is loaded (its events
    name the device set), else a `_PendingLedger`."""
    if "torch" not in sys.modules:
        return _PendingLedger()
    from .observability import compile_ledger

    return compile_ledger.ledger()


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


def _open(path: str) -> ctypes.CDLL:
    """The one place a library is opened, after the store verified it."""
    return ctypes.CDLL(path)


def build_shared(name: str, compiler: str | None, flags: list[str],
                 sources: list[str], headers: list[str] = (), build: bool = True,
                 ledger=None, runtime: bool = True) -> str | None:
    """Compile `sources` (paths under csrc/) into lib<name>-<digest>.so in
    the ahead-of-time store (`ops/aot_store.py`, over the build directory)
    and return its verified path; raises BuildError when there is no
    compiler or the compiler fails.

    The store is asked first. A library whose header, fingerprint and
    checksum verify is a `hit`. Otherwise the outcome (`miss`, `corrupt`,
    `version_mismatch`) is counted, a refused library is moved aside
    (never opened), and under a file lock the library is compiled and
    saved with its header, counted `export`. With `build=False` nothing is
    compiled: a refusal returns None (the preload's lazy half). Each call
    is also one event of the compile ledger (`ledger`, default the
    process-wide one; kernel `build/<name>`, key the digest): `hit` when
    the library was found, `miss` when it was compiled now. `runtime`:
    the library depends on the torch and CUDA runtime and the card, which
    its fingerprint then names (False for plain C that links none)."""
    from .observability import flight_recorder
    from .ops import aot_store

    if compiler is None:
        raise BuildError(f"{name}: no compiler found")
    t0 = time.monotonic()
    store = aot_store.store()
    srcs = [os.path.join(CSRC, s) for s in sources]
    deps = srcs + [os.path.join(CSRC, h) for h in headers]
    digest = _digest([os.path.basename(compiler)] + list(flags), deps)
    kernel = f"build/{name}"
    led = ledger or _process_ledger()
    fingerprint = store.current_fingerprint(compiler, flags, runtime=runtime)

    def found(path: str) -> str:
        seconds = time.monotonic() - t0
        led.note_aot(kernel, digest, "hit", seconds=seconds)
        led.record(kernel, digest, seconds, "hit")
        return path

    try:
        return found(store.load(name, digest, fingerprint))
    except aot_store.AotError as e:
        refused = aot_store.outcome(e)
        led.note_aot(kernel, digest, refused, detail=None if refused == "miss" else str(e))
    if not build:
        return None
    os.makedirs(store.root, exist_ok=True)
    with open(os.path.join(store.root, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:  # another process may have built it meanwhile
            return found(store.load(name, digest, fingerprint))
        except aot_store.AotError as e:
            refused = aot_store.outcome(e)
        if refused != "miss":
            store.move_aside(name, digest, refused)
        tmp = f"{store.library_path(name, digest)}.{os.getpid()}.tmp"
        flight_recorder.record("compile_start", kernel=kernel, key=digest)
        t1 = time.monotonic()
        proc = subprocess.run(
            [compiler] + list(flags) + ["-I", CSRC, "-o", tmp] + srcs,
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise BuildError(f"{name}: build failed\n{proc.stdout}{proc.stderr}")
        BUILD_LOG[name] = (time.monotonic() - t1, proc.stdout + proc.stderr)
        t2 = time.monotonic()
        store.save(name, digest, tmp, compiler, fingerprint)
        led.note_aot(kernel, digest, "export", seconds=time.monotonic() - t2)
        out = store.library_path(name, digest)
    led.record(kernel, digest, time.monotonic() - t0, "miss")
    return out


class Library:
    """One library of the port: its compiler (the first of `compilers`
    found; "nvcc" is looked up by `find_nvcc`), flags, sources and the
    headers its digest covers; `runtime` as in `build_shared`."""

    def __init__(self, name, compilers, flags, sources, headers=(), runtime=True):
        self.name, self.compilers = name, tuple(compilers)
        self.flags, self.sources, self.headers = list(flags), list(sources), list(headers)
        self.runtime = runtime

    def compiler(self) -> str | None:
        if self.compilers == ("nvcc",):
            return find_nvcc()
        return find_compiler(*self.compilers)

    def digest(self) -> str:
        """The digest this checkout's sources give (with the first
        candidate's name when no compiler is found)."""
        cc = self.compiler() or self.compilers[0]
        deps = [os.path.join(CSRC, f) for f in self.sources + self.headers]
        return _digest([os.path.basename(cc)] + self.flags, deps)

    def build(self, build: bool = True, ledger=None) -> str | None:
        return build_shared(self.name, self.compiler(), self.flags, self.sources,
                            self.headers, build=build, ledger=ledger, runtime=self.runtime)


HOST_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
MONT_MUL_HEADERS = ["fp_mont.cuh", "fp_mont_group.cuh"]
TOWER_HEADERS = ["tower.cuh", "tower_warp.cuh", "miller_warp.cuh", "miller_sched.cuh",
                 "tower_consts.cuh", "fp_mont.cuh"]
MXU_HEADERS = ["mxu_mont.cuh", "fp_mont.cuh"]
CC, CXX = ("cc", "gcc", "clang"), ("c++", "g++", "clang++")

LIBRARIES = {lib.name: lib for lib in (
    Library("bls12_host", CC, ["-O2", "-shared", "-fPIC"], ["host/bls12.c", "host/sha256.c",
                                                        "host/snappy_codec.c", "host/xxhash64.c",
                                                        "host/chacha20poly1305.c",
                                                        "host/aes128ctr.c",
                                                        "host/kvstore.c"],
            ["host/bls12_consts.h"], runtime=False),  # plain C: no torch, no CUDA
    Library("mont_mul_host", CXX, HOST_FLAGS, ["mont_mul_host.cpp"], MONT_MUL_HEADERS),
    Library("mont_mul", ("nvcc",), NVCC_FLAGS, ["mont_mul.cu"], MONT_MUL_HEADERS),
    Library("tower_host", CXX, HOST_FLAGS, ["tower_host.cpp"], TOWER_HEADERS),
    Library("tower", ("nvcc",), NVCC_FLAGS, ["tower.cu"], TOWER_HEADERS),
    Library("fe_probe", ("nvcc",), NVCC_FLAGS, ["fe_probe.cu"], TOWER_HEADERS),
    Library("mxu_mont_host", CXX, HOST_FLAGS, ["mxu_mont_host.cpp"], MXU_HEADERS),
    Library("mxu_mont", ("nvcc",), NVCC_FLAGS, ["mxu_mont.cu"], MXU_HEADERS),
)}

# what serving loads, by device type: the host tier, and K1, K2/K2p/K3/K3-fe
# and K4 on a card
SERVING = {"cpu": ("bls12_host",), "cuda": ("bls12_host", "mont_mul", "tower", "mxu_mont")}


def current_digests() -> dict[str, str]:
    """Each library's digest in this checkout: the pruner keeps these."""
    return {name: lib.digest() for name, lib in LIBRARIES.items()}


_LIBS: dict[str, ctypes.CDLL] = {}
_LOCKS = {name: threading.Lock() for name in LIBRARIES}  # one load of each at a time


def load(name: str, build: bool = True, ledger=None) -> ctypes.CDLL | None:
    """Library `name` opened once per process: from the store, or compiled
    first. With `build=False` a library the store refuses is left for its
    first use and None returned (nothing compiled, nothing opened).
    `ledger` is the compile ledger its outcomes go to (default the
    process-wide one)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCKS[name]:
        lib = _LIBS.get(name)
        if lib is None:
            path = LIBRARIES[name].build(build=build, ledger=ledger)
            if path is None:
                return None
            lib = _LIBS[name] = _open(path)
    return lib


def host_tier() -> ctypes.CDLL:
    return load("bls12_host")


def mont_mul_host() -> ctypes.CDLL:
    return load("mont_mul_host")


def mont_mul_cuda() -> ctypes.CDLL:
    return load("mont_mul")


def tower_host() -> ctypes.CDLL:
    return load("tower_host")


def tower_cuda() -> ctypes.CDLL:
    return load("tower")


def fe_probe_cuda() -> ctypes.CDLL:
    return load("fe_probe")


def mxu_host() -> ctypes.CDLL:
    return load("mxu_mont_host")


def mxu_cuda() -> ctypes.CDLL:
    return load("mxu_mont")


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

