"""The ahead-of-time store of the port's libraries (`ops/aot_store.py`,
routed through `build.build_shared`), on the C host tier's real build with
`cc` in a temporary store: the header and its checksum; `export` then
`hit`; a bit flip, a truncation and a garbled header each counted
`corrupt`, moved aside, rebuilt and never opened; a foreign fingerprint
and a format bump counted `version_mismatch`; a missing compiler still
raising `BuildError`; the `preload_aot` summary; `prune` keeping the
current digests; concurrent builds saving once; and the outcome labels,
the `"aot"` snapshot keys and the prune record equal to those of the JAX
ledger's `note_aot` / `note_prune` on the same calls."""

import ctypes
import hashlib
import json
import os
import threading

import pytest

from lodestar_tpu.observability import compile_ledger as jax_ledger
from lodestar_tpu.observability.stages import PipelineMetrics as JaxPipeline
from lodestar_tpu_torch import build
from lodestar_tpu_torch.observability import compile_ledger
from lodestar_tpu_torch.observability.stages import PipelineMetrics
from lodestar_tpu_torch.ops import aot_store

NAME = "bls12_host"


@pytest.fixture
def store(tmp_path, monkeypatch):
    """An empty store in a temporary build directory, the process's open
    libraries set aside, and a spy on every `ctypes.CDLL` open: the list of
    (path, sha256 of the file when it was opened)."""
    if build.LIBRARIES[NAME].compiler() is None:
        pytest.skip("no C compiler")
    root = tmp_path / "build"
    monkeypatch.setattr(build, "BUILD_DIR", str(root))
    monkeypatch.setattr(build, "_LIBS", {})
    opened = []
    real = ctypes.CDLL

    def spy(path, *a, **kw):
        with open(path, "rb") as f:
            opened.append((path, hashlib.sha256(f.read()).hexdigest()))
        return real(path, *a, **kw)

    monkeypatch.setattr(ctypes, "CDLL", spy)
    st = aot_store.store()
    assert st.root == str(root)
    return st, opened


def _outcomes(led, since=0):
    return [e["outcome"] for e in led.snapshot()["aot"]["events"][since:]
            if e["kernel"] == f"build/{NAME}"]


def _fresh(led):
    """Open the host tier anew (no cached handle) through the store."""
    build._LIBS.clear()
    return build.load(NAME, ledger=led)


def _read_header(path):
    with open(path, "rb") as f:
        raw = f.read()
    assert raw.startswith(aot_store.MAGIC + b"\n")
    return json.loads(raw[len(aot_store.MAGIC) + 1:])


def _write_header(path, header, magic=aot_store.MAGIC):
    with open(path, "wb") as f:
        f.write(magic + b"\n" + json.dumps(header, sort_keys=True).encode())


def test_export_then_hit_with_a_checksummed_header(store):
    st, opened = store
    led = compile_ledger.CompileLedger()
    pm = PipelineMetrics()
    led.attach(pm)
    lib = _fresh(led)
    assert lib.lodestar_bls_verify_sets is not None
    digest = build.LIBRARIES[NAME].digest()
    path, hdr = st.library_path(NAME, digest), st.header_path(NAME, digest)
    header = _read_header(hdr)
    with open(path, "rb") as f:
        payload = f.read()
    assert header["name"] == NAME and header["digest"] == digest
    assert header["payload_len"] == len(payload)
    assert header["payload_sha256"] == hashlib.sha256(payload).hexdigest()
    assert header["fingerprint"] == st.current_fingerprint(build.LIBRARIES[NAME].compiler(),
                                                            build.LIBRARIES[NAME].flags,
                                                            runtime=False)
    # the host tier is plain C: its fingerprint names no torch, CUDA or card
    assert set(header["fingerprint"]) == {"compiler", "flags"}
    assert set(st.current_fingerprint(build.LIBRARIES["tower_host"].compiler(),
                                      build.LIBRARIES["tower_host"].flags)) == {
        "torch", "cuda_runtime", "compiler", "device", "capability", "flags"}
    assert header["created_unix"] > 0
    assert not [n for n in os.listdir(st.root) if n.endswith(".tmp")]
    (entry,) = st.entries()
    assert entry["name"] == NAME and entry["digest"] == digest
    assert entry["bytes"] == len(payload) + os.path.getsize(hdr)
    assert _outcomes(led) == ["miss", "export"]
    _fresh(led)
    assert _outcomes(led) == ["miss", "export", "hit"]
    assert opened == [(path, header["payload_sha256"])] * 2
    snap = led.snapshot()
    assert snap["aot"]["counts"] == {"miss": 1, "export": 1, "hit": 1}
    assert snap["aot"]["loaded_executables"] == 1 and snap["aot"]["store"] == st.root
    assert snap["cache"]["aot_hits"] == 1
    assert [e["cache"] for e in snap["events"]] == ["miss", "hit"]
    text = pm.registry.expose()
    for outcome in ("miss", "export", "hit"):
        assert (f'lodestar_tpu_aot_events_total{{kernel="build/{NAME}",outcome="{outcome}"}} '
                f'1.0') in text


def _flip(path, _hdr):
    with open(path, "r+b") as f:
        f.seek(4096)
        byte = f.read(1)
        f.seek(4096)
        f.write(bytes([byte[0] ^ 0x01]))


def _truncate(path, _hdr):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _garble(_path, hdr):
    with open(hdr, "r+b") as f:
        f.seek(len(aot_store.MAGIC) + 5)
        f.write(b"\xff\x00{{")


def _foreign(_path, hdr):
    header = _read_header(hdr)
    header["fingerprint"]["compiler"] = "cc (an older release) 4.8.5"
    _write_header(hdr, header)


def _format_bump(_path, hdr):
    _write_header(hdr, _read_header(hdr), magic=aot_store.MAGIC[:-1] + b"9")


DAMAGE = {
    "bit_flip": (_flip, "corrupt", "library"),
    "truncation": (_truncate, "corrupt", "library"),
    "garbled_header": (_garble, "corrupt", "header"),
    "foreign_fingerprint": (_foreign, "version_mismatch", "header"),
    "format_bump": (_format_bump, "version_mismatch", "header"),
}


@pytest.mark.parametrize("kind", sorted(DAMAGE))
def test_a_damaged_or_foreign_library_is_counted_moved_aside_rebuilt_and_never_opened(
        store, kind):
    st, opened = store
    damage, outcome, part = DAMAGE[kind]
    led = compile_ledger.CompileLedger()
    # built, not opened: a process maps a path once, and damage to a mapped
    # library would hit the mapping
    build.LIBRARIES[NAME].build(ledger=led)
    digest = build.LIBRARIES[NAME].digest()
    path, hdr = st.library_path(NAME, digest), st.header_path(NAME, digest)
    damage(path, hdr)
    with open(path if part == "library" else hdr, "rb") as f:
        damaged = f.read()
    bad_sha = hashlib.sha256(open(path, "rb").read()).hexdigest()
    opened.clear()
    lib = _fresh(led)
    assert lib.lodestar_bls_verify_sets is not None
    assert _outcomes(led) == ["miss", "export", outcome, "export"]
    aside = (path if part == "library" else hdr) + f".{outcome}"
    with open(aside, "rb") as f:
        assert f.read() == damaged  # kept for a post-mortem, byte for byte
    new_sha = _read_header(hdr)["payload_sha256"]
    assert opened == [(path, new_sha)]
    if part == "library":
        assert bad_sha != new_sha
    asides = [e for e in st.entries() if "aside" in e]
    assert [e["aside"] for e in asides] == [outcome]
    with pytest.raises(aot_store.AotMiss):
        st.load("nothing", digest)


def test_a_missing_compiler_still_raises_build_error(store, monkeypatch):
    st, opened = store
    led = compile_ledger.CompileLedger()
    build.LIBRARIES[NAME].build(ledger=led)
    digest = build.LIBRARIES[NAME].digest()
    _flip(st.library_path(NAME, digest), None)
    opened.clear()
    monkeypatch.setattr(build, "find_compiler", lambda *names: None)
    build._LIBS.clear()
    with pytest.raises(build.BuildError, match="no compiler"):
        build.load(NAME, ledger=led)
    with pytest.raises(build.BuildError):
        build.build_shared("probe", None, ["-O2"], ["host/sha256.c"])
    assert opened == []
    summary = led.preload_aot(device="cpu")
    assert summary["outcomes"] == {NAME: "no_compiler"} and summary["loaded"] == []
    assert opened == []


def test_preload_summary(store):
    st, opened = store
    led = compile_ledger.CompileLedger()
    cold = led.preload_aot(device="cpu")
    assert cold["loaded"] == [] and cold["skipped"] == 1
    assert cold["outcomes"] == {NAME: "miss"} and cold["launch_seconds"] == {}
    assert opened == [] and not os.path.exists(st.root) or not st.entries()
    build.load(NAME, ledger=led)  # the lazy half builds it
    build._LIBS.clear()
    warm_led = compile_ledger.CompileLedger()
    warm = warm_led.preload_aot(device="cpu")
    digest = build.LIBRARIES[NAME].digest()
    assert warm["loaded"] == [f"build/{NAME}:{digest}"] and warm["skipped"] == 0
    assert warm["outcomes"] == {NAME: "hit"} and warm["device"] == "cpu"
    assert set(warm) >= {"loaded", "skipped", "seconds"}  # the JAX summary's keys
    assert warm["load_seconds"][NAME] >= 0 and warm["seconds"] >= 0
    assert NAME in build._LIBS and len(opened) == 2
    again = warm_led.preload_aot(device="cpu")  # already open: skipped
    assert again["loaded"] == [] and again["skipped"] == 1
    assert warm_led.preload_aot(device="cpu", kernels=())["skipped"] == 0
    assert warm_led.snapshot()["aot"]["counts"] == {"hit": 1}


def test_prune_keeps_the_current_digests(store):
    st, _ = store
    led = compile_ledger.CompileLedger()
    _fresh(led)
    lib = build.LIBRARIES[NAME]
    digest = lib.digest()
    # a library of stale sources, and one moved aside
    for stale in ("0" * 16, "1" * 16):
        tmp = os.path.join(st.root, f"stale-{stale}.tmp")
        with open(st.library_path(NAME, digest), "rb") as f, open(tmp, "wb") as g:
            g.write(f.read())
        st.save(NAME, stale, tmp, lib.compiler(), st.current_fingerprint(lib.compiler(),
                                                                         lib.flags))
        os.utime(st.library_path(NAME, stale), (1, 1 + int(stale[0])))
    st.move_aside(NAME, "1" * 16, "corrupt")
    assert len(st.entries()) == 3
    current = {(NAME, digest)}
    kept = st.prune(10 ** 12, current)
    assert kept["removed"] == [] and kept["entries_remaining"] == 3
    result = st.prune(0, current)
    assert result["removed"] == [st.library_path(NAME, "1" * 16) + ".corrupt",
                                 st.library_path(NAME, "0" * 16)]
    assert result["entries"] == 3 and result["entries_remaining"] == 1
    assert result["total_bytes"] > result["removed_bytes"] > 0
    (left,) = st.entries()
    assert left["digest"] == digest and os.path.exists(st.header_path(NAME, digest))
    # the default current set is the checkout's
    assert build.current_digests()[NAME] == digest
    assert st.prune(0)["removed"] == []
    # the ledger's record of it, as the JAX ledger keeps it
    records = []
    for mod, pipeline in ((compile_ledger, PipelineMetrics), (jax_ledger, JaxPipeline)):
        own = mod.CompileLedger()
        pm = pipeline()
        own.attach(pm)
        own.note_prune(result)
        rec = own.snapshot()["last_prune"]
        rec.pop("unix_time")
        records.append((rec, pm.compile_cache_pruned.value()))
    assert records[0] == records[1]
    assert records[0][0]["removed"] == 2


def test_concurrent_builds_save_once(store):
    st, _ = store
    lib = build.LIBRARIES[NAME]
    led = compile_ledger.CompileLedger()
    paths, errors = [], []

    def build_one():
        try:
            paths.append(build.build_shared(NAME, lib.compiler(), lib.flags, lib.sources,
                                            lib.headers, ledger=led))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build_one) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(set(paths)) == 1 and len(paths) == 6
    counts = led.snapshot()["aot"]["counts"]
    assert counts["export"] == 1 and counts["hit"] == 5
    st.load(NAME, lib.digest())


CALLS = [
    ("build/bls12_host", "df30", "miss", 0.0, None),
    ("build/bls12_host", "df30", "export", 1.25, None),
    ("build/bls12_host", "df30", "hit", 0.001, None),
    ("build/tower", "ab12", "corrupt", 0.0, "library checksum mismatch"),
    ("build/tower", "ab12", "export", 40.0, None),
    ("build/mont_mul", "cd34", "version_mismatch", 0.0, "built for another toolchain"),
]


def test_outcomes_and_snapshot_keys_match_the_jax_ledger():
    docs, texts = [], []
    for mod, pipeline in ((compile_ledger, PipelineMetrics), (jax_ledger, JaxPipeline)):
        led = mod.CompileLedger()
        pm = pipeline()
        led.attach(pm)
        for kernel, key, outcome, seconds, detail in CALLS:
            led.note_aot(kernel, key, outcome, seconds=seconds, detail=detail)
        aot = led.snapshot()["aot"]
        docs.append((sorted(aot), aot["counts"], aot["events"]))
        texts.append(sorted(ln for ln in pm.registry.expose().splitlines()
                            if ln.startswith("lodestar_tpu_aot_events_total")))
    assert docs[0] == docs[1]
    assert texts[0] == texts[1] and len(texts[0]) == 6
    assert docs[0][1] == {"miss": 1, "export": 2, "hit": 1, "corrupt": 1,
                          "version_mismatch": 1}
    assert set(aot_store.OUTCOMES.values()) | {"hit", "export"} == set(docs[0][1])
