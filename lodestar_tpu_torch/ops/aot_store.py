"""The ahead-of-time store of the port's compiled libraries (the contract
of the JAX package's `ops/aot_store.py` over `build.build_shared`).

The JAX store persists serialized XLA executables. What the port compiles
ahead of time is its shared libraries, one per kernel source (a CUDA
graph lives inside one process and cannot be serialized). `build.py`
names each library by a digest of its sources, headers and command; this
module adds the rest of the contract:

- every library `lib<name>-<digest>.so` has a header beside it,
  `lib<name>-<digest>.so.hdr`, written with it: both through a temporary
  file and `os.replace`, the library first, so a reader sees the old
  pair, the new pair or a library without a header (a miss), never a
  half-written file under a final name;
- the header records the build's fingerprint: the torch version, the
  CUDA runtime, the compiler's `--version`, the device name and compute
  capability and the flags. A library stamped with another fingerprint
  (a new `nvcc`, torch or card) is `AotVersionMismatch`, not reused. The
  C host tier links neither torch nor CUDA: its fingerprint is the
  compiler and the flags alone, so a process without PyTorch loads it;
- the header carries the library's SHA-256 and length, verified before
  the library is opened: a truncated or bit-flipped library, or a
  garbled header, is `AotCorrupt` and never reaches `ctypes.CDLL`. The
  checksum is an integrity check, not an authenticity one: the store has
  the trust of the checkout's own sources;
- `entries()` lists the store, `prune(limit_bytes)` removes the least
  recently used libraries of sources no longer current (never a current
  digest), and `move_aside` keeps a refused library for a post-mortem.

Header file layout:

    8 bytes   magic b"LTPTAOT1" (the trailing digit is the format version;
              another version reads as version_mismatch, not corruption)
    1 byte    b"\\n"
    N bytes   JSON {name, digest, compiler, fingerprint{...},
              payload_sha256, payload_len, created_unix}

The store's directory is an argument (default `build.BUILD_DIR`; nothing
is read from the environment). `build.py` counts every outcome in the
compile ledger (`hit`, `miss`, `corrupt`, `version_mismatch`, `export`);
this module touches no metric, so tools can use it alone:

    python3 -m lodestar_tpu_torch.ops.aot_store            # list the store
    python3 -m lodestar_tpu_torch.ops.aot_store --prune 64M
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import tempfile
import threading
import time

__all__ = [
    "AotError",
    "AotMiss",
    "AotCorrupt",
    "AotVersionMismatch",
    "AotStore",
    "compiler_version",
    "runtime_fingerprint",
    "store",
]

MAGIC = b"LTPTAOT1"
_MAGIC_STEM = MAGIC[:-1]  # any version of the format
_HEADER_MAX = 1 << 20  # a header is ~500 bytes; 1 MiB means corrupt
HEADER_SUFFIX = ".hdr"
ASIDE = (".corrupt", ".version_mismatch")


class AotError(Exception):
    """Base of every store failure."""


class AotMiss(AotError):
    """No library (or no header) for this name and digest: the cold case."""


class AotCorrupt(AotError):
    """A header or library that is truncated, bit-flipped or unreadable."""


class AotVersionMismatch(AotError):
    """An intact library of another build fingerprint or store format."""


OUTCOMES = {AotMiss: "miss", AotCorrupt: "corrupt", AotVersionMismatch: "version_mismatch"}


def outcome(err: AotError) -> str:
    """The compile ledger's outcome name of a store error."""
    return OUTCOMES.get(type(err), "corrupt")


_runtime: dict | None = None
_compilers: dict[str, str] = {}
_lock = threading.Lock()


def runtime_fingerprint() -> dict:
    """The process's part of a fingerprint: torch, the CUDA runtime, and the
    current card's name and compute capability ("cpu" and None without
    one). Computed once per process."""
    global _runtime
    with _lock:
        if _runtime is None:
            import torch

            fp = {"torch": torch.__version__, "cuda_runtime": torch.version.cuda or "none",
                  "device": "cpu", "capability": None}
            if torch.cuda.is_available():
                idx = torch.cuda.current_device()
                major, minor = torch.cuda.get_device_capability(idx)
                fp.update(device=torch.cuda.get_device_name(idx), capability=f"sm_{major}{minor}")
            _runtime = fp
        return dict(_runtime)


def compiler_version(compiler: str | None) -> str:
    """The lines of `compiler --version` that carry a version (a digit, no
    copyright notice), joined by "; "; "missing" when it cannot run.
    Cached per compiler path."""
    if compiler is None:
        return "missing"
    with _lock:
        known = _compilers.get(compiler)
    if known is not None:
        return known
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True, text=True,
                              timeout=60)
        lines = [ln.strip() for ln in (proc.stdout or proc.stderr).splitlines()]
        text = "; ".join(ln for ln in lines
                         if any(c.isdigit() for c in ln) and "Copyright" not in ln)
    except (OSError, subprocess.TimeoutExpired):
        text = ""
    text = text or "missing"
    with _lock:
        _compilers[compiler] = text
    return text


def _sha256_file(path: str) -> tuple[str, int]:
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
            n += len(chunk)
    return h.hexdigest(), n


class AotStore:
    """One directory of libraries and their headers, addressed by (name,
    digest). Loads only read and saves are atomic renames, so processes
    may share it; `build.py` serialises the builds of one library with a
    file lock."""

    def __init__(self, root: str | None = None):
        if root is None:
            from ..build import BUILD_DIR

            root = BUILD_DIR
        self.root = os.path.abspath(root)

    def current_fingerprint(self, compiler: str | None = None, flags=(),
                            runtime: bool = True) -> dict:
        """The fingerprint a library built now would carry: with `runtime`
        the process's part (a library of plain C, the host tier, links
        neither torch nor CUDA and carries none), and with `compiler` its
        version and the flags."""
        fp = runtime_fingerprint() if runtime else {}
        if compiler is not None:
            fp["compiler"] = compiler_version(compiler)
            fp["flags"] = " ".join(flags)
        return fp

    def library_path(self, name: str, digest: str) -> str:
        return os.path.join(self.root, f"lib{name}-{digest}.so")

    def header_path(self, name: str, digest: str) -> str:
        return self.library_path(name, digest) + HEADER_SUFFIX

    # -- producer -------------------------------------------------------------

    def save(self, name: str, digest: str, built: str, compiler: str, fingerprint: dict) -> dict:
        """Install the freshly compiled library at `built` (a temporary file
        in the store's directory) under its final name, with its header.
        Returns the header."""
        sha, n = _sha256_file(built)
        header = {
            "name": name,
            "digest": digest,
            "compiler": compiler,
            "fingerprint": fingerprint,
            "payload_sha256": sha,
            "payload_len": n,
            "created_unix": round(time.time(), 1),
        }
        fd, tmp = tempfile.mkstemp(dir=self.root, prefix=f"lib{name}-", suffix=".hdr.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(MAGIC + b"\n" + json.dumps(header, sort_keys=True).encode())
                f.flush()
                os.fsync(f.fileno())
            os.replace(built, self.library_path(name, digest))
            os.replace(tmp, self.header_path(name, digest))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass  # already renamed
            raise
        return header

    # -- consumer -------------------------------------------------------------

    def read_header(self, path: str) -> dict:
        """Parse a header file without touching its library; raises
        AotMiss, AotCorrupt or AotVersionMismatch."""
        try:
            with open(path, "rb") as f:
                raw = f.read(_HEADER_MAX + len(MAGIC) + 2)
        except FileNotFoundError:
            raise AotMiss(path) from None
        except OSError as e:
            raise AotCorrupt(f"unreadable header: {e!r}") from e
        magic = raw[:len(MAGIC)]
        if magic != MAGIC:
            if magic.startswith(_MAGIC_STEM):
                raise AotVersionMismatch(f"store format {magic!r}")
            raise AotCorrupt("bad magic")
        body = raw[len(MAGIC):]
        if not body.startswith(b"\n") or len(body) > _HEADER_MAX:
            raise AotCorrupt("malformed header")
        try:
            header = json.loads(body[1:])
        except ValueError as e:
            raise AotCorrupt(f"header not JSON: {e!r}") from e
        if not isinstance(header, dict):
            raise AotCorrupt("header not an object")
        return header

    def load(self, name: str, digest: str, fingerprint: dict | None = None) -> str:
        """The verified path of library (name, digest), to be opened now:
        its header parsed, its fingerprint equal to `fingerprint` (default:
        the current fingerprint of the compiler the header names), its
        length and SHA-256 equal to the header's. Raises AotMiss,
        AotCorrupt or AotVersionMismatch; nothing it refuses is opened."""
        lib = self.library_path(name, digest)
        header = self.read_header(self.header_path(name, digest))
        if header.get("name") != name or header.get("digest") != digest:
            raise AotCorrupt("header name or digest mismatch")
        have = header.get("fingerprint")
        if fingerprint is None:
            flags = (have or {}).get("flags", "") if isinstance(have, dict) else ""
            fingerprint = self.current_fingerprint(header.get("compiler"), flags.split())
        if have != fingerprint:
            raise AotVersionMismatch(f"built for {have}")
        try:
            sha, n = _sha256_file(lib)
        except FileNotFoundError:
            raise AotCorrupt("header without its library") from None
        except OSError as e:
            raise AotCorrupt(f"unreadable library: {e!r}") from e
        if n != header.get("payload_len"):
            raise AotCorrupt(f"library {n} B, header says {header.get('payload_len')} B")
        if sha != header.get("payload_sha256"):
            raise AotCorrupt("library checksum mismatch")
        try:
            os.utime(lib)  # recency for the pruner
        except OSError:
            pass  # a read-only store: the pruner falls back to the build time
        return lib

    def move_aside(self, name: str, digest: str, why: str) -> list[str]:
        """Rename a refused library and its header to `<path>.<why>` (one
        kept per reason); returns the new paths."""
        moved = []
        for path in (self.library_path(name, digest), self.header_path(name, digest)):
            if os.path.exists(path):
                os.replace(path, f"{path}.{why}")
                moved.append(f"{path}.{why}")
        return moved

    # -- introspection ----------------------------------------------------------

    def entries(self) -> list[dict]:
        """One dict per library in the store: its header's name, digest,
        fingerprint, payload_len and created_unix (or `error` when the
        header is missing or unreadable), `bytes` (library and header),
        `mtime`, `path` and `header`; libraries moved aside carry
        `aside`."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        out = []
        for fname in names:
            aside = next((w for w in ASIDE if fname.endswith(".so" + w)), None)
            if not (fname.startswith("lib") and (fname.endswith(".so") or aside)):
                continue
            path = os.path.join(self.root, fname)
            hdr = (path[:-len(aside)] + HEADER_SUFFIX + aside) if aside else path + HEADER_SUFFIX
            try:
                h = self.read_header(hdr)
                entry = {k: h.get(k) for k in ("name", "digest", "fingerprint", "payload_len",
                                               "created_unix")}
            except AotError as e:
                entry = {"error": f"{type(e).__name__}: {e}"}
            size = 0
            for p in (path, hdr):
                try:
                    size += os.path.getsize(p)
                except OSError:
                    pass
            try:
                entry["mtime"] = os.path.getmtime(path)
            except OSError:
                entry["mtime"] = 0.0
            entry.update(bytes=size, path=path, header=hdr)
            if aside:
                entry["aside"] = aside[1:]
            out.append(entry)
        return out

    def prune(self, limit_bytes: int, current=None) -> dict:
        """Remove libraries (with their headers) until the store holds at
        most `limit_bytes`: first those moved aside, then the least
        recently used of digests not in `current`, a set of (name, digest)
        (default: the checkout's, `build.current_digests()`). A current
        digest is never removed, even when the store stays over the limit.
        Returns what was done, in the shape the compile ledger's
        `note_prune` records."""
        if current is None:
            from ..build import current_digests

            current = set(current_digests().items())
        keep = {self.library_path(n, d) for n, d in current}
        entries = self.entries()
        total = sum(e["bytes"] for e in entries)
        candidates = sorted((e for e in entries if "aside" in e or e["path"] not in keep),
                            key=lambda e: ("aside" not in e, e["mtime"]))
        left, removed, removed_bytes = total, [], 0
        for e in candidates:
            if left <= limit_bytes:
                break
            for p in (e["path"], e["header"]):
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
            removed.append(e["path"])
            removed_bytes += e["bytes"]
            left -= e["bytes"]
        return {"entries": len(entries), "entries_remaining": len(entries) - len(removed),
                "removed": removed, "removed_bytes": removed_bytes, "total_bytes": total,
                "limit_bytes": limit_bytes}


_store: AotStore | None = None


def store() -> AotStore:
    """The process-wide store over `build.BUILD_DIR`, made anew when that
    directory changes (tests point it at temporary directories)."""
    global _store
    from ..build import BUILD_DIR

    s = _store
    if s is None or s.root != os.path.abspath(BUILD_DIR):
        s = _store = AotStore(BUILD_DIR)
    return s


def _parse_bytes(text: str) -> int:
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}
    text = text.strip().upper()
    if text and text[-1] in units:
        return int(float(text[:-1]) * units[text[-1]])
    return int(text)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="List or prune the port's library store.")
    ap.add_argument("--root", default=None, help="the store's directory (default: the build "
                                                 "directory of the checkout)")
    ap.add_argument("--prune", default=None, metavar="BYTES",
                    help="remove libraries of stale sources until the store holds at most "
                         "BYTES (suffix K, M or G)")
    args = ap.parse_args(argv)
    st = AotStore(args.root)
    if args.prune is None:
        print(json.dumps({"root": st.root, "entries": st.entries()}, indent=1))
        return 0
    from ..observability import compile_ledger

    result = st.prune(_parse_bytes(args.prune))
    compile_ledger.ledger().note_prune(result)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
