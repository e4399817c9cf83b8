"""The port's warm start (batch_shipyard_tpu_torch/compilecache) on the
CPU: the identity key and the hit/miss/saved-seconds tracking of the
manager, its flags, the kernel-library cache of ops/_build.py driven by a
stand-in ``nvcc`` the test puts first on PATH (a second process with no
nvcc reachable builds nothing and reports a hit; logs are not entries;
two cold processes at once leave one library and a readable meta),
pool-wide seeding over the port's state store (the reference's cases),
seeds carried between the two packages both ways, precompile_async's
goodput event and span, and the workload's compile events priced by the
reference's accounting and the port's alike."""

import io
import json
import logging
import os
import pathlib
import shutil
import subprocess
import sys
import tarfile
import textwrap
import time

import pytest

from batch_shipyard_tpu.compilecache import manager as ref_manager
from batch_shipyard_tpu.compilecache import seeding as ref_seeding
from batch_shipyard_tpu.goodput import accounting as ref_accounting
from batch_shipyard_tpu.goodput import events as ref_events
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.compilecache import aot, manager, seeding
from batch_shipyard_tpu_torch.goodput import accounting as port_accounting
from batch_shipyard_tpu_torch.goodput import events as port_events
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore

REPO = pathlib.Path(__file__).resolve().parent.parent

_ID_ARGS = dict(torch_version="2.11.0+cu128", cuda_version="12.8",
                backend="cuda", device_kind="NVIDIA H100 80GB HBM3",
                capability="sm_90", device_count=1, process_count=4,
                mesh_shape={"dp": 2, "sp": 2}, model_digest="abc123")


@pytest.fixture(autouse=True)
def no_global_manager():
    """Each test starts and ends with no process-global manager (enable()
    installs one, and a later test file in this worker would build into
    its deleted dir)."""
    saved = manager._current
    manager._current = None
    yield
    manager._current = saved


# --------------------------- identity key ------------------------------

def test_identity_key_stable_for_identical_inputs():
    assert manager.identity_key(**_ID_ARGS) == \
        manager.identity_key(**dict(_ID_ARGS))


@pytest.mark.parametrize("field,value", [
    ("torch_version", "2.12.0+cu128"),
    ("cuda_version", "12.9"),
    ("backend", "cpu"),
    ("device_kind", "NVIDIA H200"),
    ("capability", "sm_100"),
    ("device_count", 4),
    ("process_count", 8),
    ("mesh_shape", {"dp": 1, "sp": 4}),
    ("model_digest", "def456"),
])
def test_identity_key_changes_per_field(field, value):
    changed = dict(_ID_ARGS, **{field: value})
    assert manager.identity_key(**changed) != \
        manager.identity_key(**_ID_ARGS)


def test_identity_key_resolves_left_out_fields_from_torch():
    """Fields left out come from the live runtime (here: the CPU, one
    process); given explicitly they give the same key."""
    import torch
    live = manager.identity_key(backend="cpu", model_digest="m")
    assert live == manager.identity_key(
        torch_version=torch.__version__,
        cuda_version=torch.version.cuda or "", backend="cpu",
        device_kind="cpu", capability="", device_count=1,
        process_count=1, model_digest="m")


def _attention(q, k, v, causal):
    return q


def test_config_digest_stable_and_sensitive():
    import dataclasses

    from batch_shipyard_tpu_torch.models import transformer as tfm

    @dataclasses.dataclass
    class Cfg:
        d_model: int = 64
        fn: object = _attention

    assert manager.config_digest(Cfg()) == manager.config_digest(Cfg())
    assert manager.config_digest(Cfg(d_model=128)) != \
        manager.config_digest(Cfg())

    class Opaque:
        pass

    assert manager.config_digest({"x": Opaque()}) == \
        manager.config_digest({"x": Opaque()})
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                d_head=16, d_ff=64)
    assert manager.config_digest(tfm.TransformerConfig(**base)) == \
        manager.config_digest(tfm.TransformerConfig(**base))
    assert manager.config_digest(tfm.TransformerConfig(**base)) != \
        manager.config_digest(tfm.TransformerConfig(**base,
                                                    fused_norm=True))


# ------------------------ track: hit/miss/saved ------------------------

def _fake_build(mgr, label, entry, cold_sleep=0.05):
    with mgr.track(label) as result:
        path = os.path.join(mgr.cache_dir, entry)
        if not os.path.exists(path):
            time.sleep(cold_sleep)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write("x" * 2048)
    return result


def test_track_records_miss_then_hit_with_saved_seconds(tmp_path):
    mgr = manager.enable(str(tmp_path / "cache"), identity="idA")
    cold = _fake_build(mgr, "step", "libstep.so")
    assert cold["cache_hit"] is False and cold["new_entries"] == 1
    assert cold["saved_seconds"] == 0.0
    # A fresh process is a fresh manager over the same dir.
    mgr = manager.enable(str(tmp_path / "cache"), identity="idA")
    warm = _fake_build(mgr, "step", "libstep.so")
    assert warm["cache_hit"] is True and warm["new_entries"] == 0
    assert warm["saved_seconds"] > 0.0
    stats = mgr.stats()
    assert stats["hits"] == 1 and stats["misses"] == 0
    assert stats["entries"] == 1 and stats["identity"] == "idA"


def test_track_repeat_label_is_not_a_hit(tmp_path):
    mgr = manager.enable(str(tmp_path / "cache"), identity="idA")
    _fake_build(mgr, "warmup", "libwarm.so")
    repeat = _fake_build(mgr, "warmup", "libwarm.so")
    assert repeat["in_process_reuse"] is True
    assert repeat["cache_hit"] is False and repeat["saved_seconds"] == 0.0
    assert (mgr.hits, mgr.misses) == (0, 1)
    attrs = {}
    with manager.tracked(attrs, "warmup"):
        pass
    assert "cache_hit" not in attrs


def test_tracked_stamps_attrs(tmp_path):
    attrs = {}
    with manager.tracked(attrs, "warmup"):
        pass
    assert attrs == {}  # no manager: no-op
    mgr = manager.enable(str(tmp_path / "cache"), identity="idA")
    _fake_build(mgr, "warmup", "libwarm.so")
    manager.enable(str(tmp_path / "cache"), identity="idA")
    with manager.tracked(attrs, "warmup"):
        pass
    assert attrs["cache_hit"] is True and attrs["saved_seconds"] >= 0.0


def test_identities_coexist_and_layout_is_the_references(tmp_path):
    """One subdir per identity under a root; the reference's manager
    reads the port's layout (identities, stamps, entries)."""
    root = str(tmp_path / "cache")
    mgr_a = manager.enable(root, identity="idA")
    _fake_build(mgr_a, "step", "libstep.so")
    mgr_b = manager.enable(root, identity="idB")
    assert mgr_b.entries() == {} and mgr_a.entries() != {}
    dirs = manager.list_identity_dirs(root)
    assert sorted(dirs) == ["idA", "idB"]
    assert dirs == ref_manager.list_identity_dirs(root)
    for ident, path in dirs.items():
        assert manager.read_identity(path) == ident == \
            ref_manager.read_identity(path)
        assert manager.snapshot(path) == ref_manager.snapshot(path)


def test_flags_env_default_and_opt_out(monkeypatch, tmp_path):
    import argparse

    def parse(argv):
        parser = argparse.ArgumentParser()
        parser.add_argument("--device", default=None)
        manager.add_compile_cache_args(parser)
        return parser.parse_args(argv)
    monkeypatch.delenv(manager.CACHE_DIR_ENV, raising=False)
    assert manager.enable_from_args(parse([])) is None
    monkeypatch.setenv(manager.CACHE_DIR_ENV, str(tmp_path / "env"))
    args = parse(["--device", "cpu"])
    assert args.compile_cache_dir == str(tmp_path / "env")
    assert not args.aot_precompile
    mgr = manager.enable_from_args(args, mesh_shape={"dp": 1},
                                   model_digest="m")
    assert mgr is manager.current()
    assert mgr.cache_dir.startswith(str(tmp_path / "env" / "ident-"))
    # --device cpu keys the identity to the CPU backend.
    assert mgr.identity == manager.identity_key(
        backend="cpu", mesh_shape={"dp": 1}, model_digest="m")
    manager._current = None
    assert manager.enable_from_args(
        parse(["--no-compile-cache", "--device", "cpu"])) is None
    assert manager.current() is None


def test_unwritable_dir_disables_the_cache_without_raising(tmp_path,
                                                           caplog):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a dir")

    class Args:
        compile_cache_dir = str(blocker / "cache")
        no_compile_cache = False
        device = "cpu"
    with caplog.at_level(logging.WARNING):
        assert manager.enable_from_args(Args()) is None
    assert manager.current() is None
    assert "compile cache enable failed" in caplog.text
    assert _build.build_dir() == _build.BUILD_DIR


# ------------------ the library cache, stand-in nvcc -------------------

_BUILD_SCRIPT = textwrap.dedent("""
    import json, sys
    from batch_shipyard_tpu_torch.compilecache import manager
    from batch_shipyard_tpu_torch.ops import _build
    mgr = manager.enable(sys.argv[1], identity=sys.argv[2])
    with mgr.track("build") as result:
        path, seconds = _build.build("fused_norm")
    print(json.dumps({"path": str(path), "seconds": seconds,
                      "built": _build.built, "hit": result["cache_hit"],
                      "new": result["new_entries"],
                      "in_cache": str(path.parent) == mgr.cache_dir}))
""")


@pytest.fixture
def stand_in_nvcc(tmp_path):
    """A directory holding an executable ``nvcc`` that writes a stand-in
    library at its ``-o`` path after a short pause, and the compiler
    output a real build logs."""
    bindir = tmp_path / "standin_bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + textwrap.dedent("""
        import sys, time
        out = sys.argv[sys.argv.index("-o") + 1]
        time.sleep(0.3)
        with open(out, "wb") as fh:
            fh.write(b"stand-in library")
        print("ptxas info    : Used 1 registers")
    """))
    nvcc.chmod(0o755)
    return bindir


def _env(path_dirs=(), cuda_home=None):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    # No real nvcc here, and the test's own stand-in decides.
    path = [d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc"))]
    env["PATH"] = os.pathsep.join([str(d) for d in path_dirs] + path)
    if cuda_home is not None:
        env["CUDA_HOME"] = str(cuda_home)
    return env


def _build_process(root, env):
    return subprocess.Popen(
        [sys.executable, "-c", _BUILD_SCRIPT, str(root), "idX"],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _result(proc):
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1])


def test_second_process_builds_nothing_and_never_looks_for_nvcc(
        tmp_path, stand_in_nvcc):
    root = tmp_path / "cache"
    cold = _result(_build_process(root, _env([stand_in_nvcc])))
    assert cold["in_cache"] and cold["seconds"] > 0
    assert cold["built"] == {"fused_norm": cold["seconds"]}
    assert cold["new"] == 1 and cold["hit"] is False
    ident = manager.identity_subdir(str(root), "idX")
    assert pathlib.Path(cold["path"]).parent == pathlib.Path(ident)
    # The log sits in logs/, not beside the library: not an entry.
    entries = manager.snapshot(ident)
    assert list(entries) == [pathlib.Path(cold["path"]).name]
    assert "Used 1 registers" in _build.log_path(
        pathlib.Path(cold["path"])).read_text()
    empty = tmp_path / "no_cuda_home"
    empty.mkdir()
    warm = _result(_build_process(root, _env(cuda_home=empty)))
    assert warm["path"] == cold["path"] and warm["seconds"] == 0.0
    assert warm["built"] == {} and warm["new"] == 0
    assert warm["hit"] is True
    assert manager.snapshot(ident) == entries


def test_cold_processes_together_leave_one_library_and_a_meta(
        tmp_path, stand_in_nvcc):
    root = tmp_path / "cache"
    env = _env([stand_in_nvcc])
    procs = [_build_process(root, env) for _ in range(2)]
    results = [_result(p) for p in procs]
    assert results[0]["path"] == results[1]["path"]
    ident = manager.identity_subdir(str(root), "idX")
    names_now = sorted(os.listdir(ident))
    lib = pathlib.Path(results[0]["path"]).name
    assert names_now == sorted(["cache_meta.json", "identity.json",
                                "logs", lib])
    assert (pathlib.Path(ident) / lib).read_bytes() == b"stand-in library"
    with open(os.path.join(ident, "cache_meta.json"),
              encoding="utf-8") as fh:
        meta = json.load(fh)
    assert meta["cold_seconds"]["build"] > 0


# ------------------------------ seeding --------------------------------

def _seeded_store(tmp_path, identity="idA"):
    store = MemoryStateStore()
    cache = str(tmp_path / "node-a")
    mgr = manager.enable(cache, identity=identity)
    _fake_build(mgr, "step", "libstep-1.so")
    _fake_build(mgr, "prefill", "libprefill-1.so")
    assert seeding.export_cache(store, "pool1", cache, "node-a")
    return store, cache


def test_export_seed_round_trip_hits_on_fresh_node(tmp_path):
    store, _ = _seeded_store(tmp_path)
    assert seeding.latest_info(store, "pool1")["identities"]["idA"][
        "entries"] == 2
    fresh = str(tmp_path / "node-b")
    assert seeding.seed_cache(store, "pool1", fresh) == seeding.SEEDED
    mgr = manager.enable(fresh, identity="idA")
    warm = _fake_build(mgr, "step", "libstep-1.so")
    assert warm["cache_hit"] is True and warm["saved_seconds"] > 0.0


def test_seed_refuses_unpublished_pinned_identity(tmp_path):
    store, _ = _seeded_store(tmp_path)
    fresh = str(tmp_path / "node-c")
    assert seeding.seed_cache(store, "pool1", fresh,
                              expected_identity="idOTHER") == \
        seeding.REFUSED
    assert manager.list_identity_dirs(fresh) == {}
    mixed = str(tmp_path / "node-d")
    manager.enable(mixed, identity="idOTHER")
    assert seeding.seed_cache(store, "pool1", mixed) == seeding.SEEDED
    assert manager.snapshot(manager.identity_subdir(mixed,
                                                    "idOTHER")) == {}
    assert "libstep-1.so" in manager.snapshot(
        manager.identity_subdir(mixed, "idA"))


def test_export_handles_mixed_identities(tmp_path):
    store, cache = _seeded_store(tmp_path)
    _fake_build(manager.enable(cache, identity="idB"), "other",
                "libother-1.so")
    assert seeding.export_cache(store, "pool1", cache,
                                "node-a") is not None
    identities = seeding.latest_info(store, "pool1")["identities"]
    assert identities["idA"]["entries"] == 2
    assert identities["idB"]["entries"] == 1


def test_export_skips_when_pool_has_equal_or_newer(tmp_path):
    store, cache = _seeded_store(tmp_path)
    assert seeding.export_cache(store, "pool1", cache, "node-a") is None
    _fake_build(manager.enable(cache, identity="idA"), "decode",
                "libdecode-1.so")
    assert seeding.export_cache(store, "pool1", cache,
                                "node-a") is not None
    assert seeding.latest_info(store, "pool1")["identities"]["idA"][
        "entries"] == 3


def test_export_respects_the_lease(tmp_path):
    store = MemoryStateStore()
    cache = str(tmp_path / "node-a")
    _fake_build(manager.enable(cache, identity="idA"), "step",
                "libstep-1.so")
    held = store.acquire_lease(
        names.compile_cache_lease_key("pool1", "idA"), 30.0, "other")
    assert held is not None
    assert seeding.export_cache(store, "pool1", cache, "node-a") is None
    store.release_lease(held)
    assert seeding.export_cache(store, "pool1", cache,
                                "node-a") is not None


def test_seed_skips_when_local_is_as_warm(tmp_path):
    store, cache = _seeded_store(tmp_path)
    assert seeding.seed_cache(store, "pool1", cache) == seeding.SKIP
    assert seeding.seed_cache(MemoryStateStore(), "pool1",
                              cache) == seeding.ABSENT


def test_prune_and_stats(tmp_path):
    store, _ = _seeded_store(tmp_path)
    report = seeding.stats(store, "pool1")
    assert report["identities"]["idA"]["entries"] == 2
    assert report["artifacts"] == [names.compile_cache_key("pool1", "idA")]
    assert seeding.prune(store, "pool1") == 2  # tar + latest.json
    assert seeding.latest_info(store, "pool1") is None
    assert seeding.stats(store, "pool1")["artifacts"] == []


def test_seed_rejects_traversal_members(tmp_path):
    store = MemoryStateStore()
    buffer = io.BytesIO()
    with tarfile.open(fileobj=buffer, mode="w") as tar:
        for name in ("../escape.so", "sub/dir.so", "ok.so"):
            info = tarfile.TarInfo(name)
            info.size = 4
            tar.addfile(info, io.BytesIO(b"evil"))
    store.put_object(names.compile_cache_key("pool1", "idA"),
                     buffer.getvalue())
    store.put_object(names.compile_cache_latest_key("pool1"), json.dumps(
        {"identities": {"idA": {
            "entries": 3, "key": names.compile_cache_key("pool1", "idA")}}
         }).encode())
    target = str(tmp_path / "seedme")
    assert seeding.seed_cache(store, "pool1", target) == seeding.SEEDED
    assert sorted(manager.snapshot(
        manager.identity_subdir(target, "idA"))) == ["ok.so"]
    assert not (tmp_path / "escape.so").exists()
    assert not (tmp_path / "seedme" / "escape.so").exists()


# ------------------------ across the two packages ----------------------

def _copy_objects(src, dst, prefix="compilecache/"):
    for key in src.list_objects(prefix):
        dst.put_object(key, src.get_object(key))


def test_reference_seeding_carries_a_port_cache_root(tmp_path):
    """The reference's agent-side export and seed carry a cache root the
    port wrote (libraries, logs, sidecars) unchanged, and the port's
    export of the same root is the same tar, byte for byte."""
    root = str(tmp_path / "port-node")
    mgr = manager.enable(root, identity=manager.identity_key(**_ID_ARGS))
    _fake_build(mgr, "transformer_warmup", "libflash_attention-0123.so")
    _fake_build(mgr, "transformer_warmup", "libchunked_loss-4567.so")
    logs = pathlib.Path(mgr.cache_dir) / _build.LOG_DIR
    logs.mkdir()
    (logs / "libflash_attention-0123.log").write_text("ptxas info")
    ref_store, port_store = RefStore(), MemoryStateStore()
    assert ref_seeding.export_cache(ref_store, "pool1", root, "node-a")
    assert seeding.export_cache(port_store, "pool1", root, "node-a")
    key = names.compile_cache_key("pool1", mgr.identity)
    assert ref_store.get_object(key) == port_store.get_object(key)
    ref_latest = ref_seeding.latest_info(ref_store, "pool1")
    port_latest = seeding.latest_info(port_store, "pool1")
    for latest in (ref_latest, port_latest):
        latest["identities"][mgr.identity].pop("updated_at")
    assert ref_latest == port_latest
    fresh = str(tmp_path / "ref-node")
    assert ref_seeding.seed_cache(ref_store, "pool1", fresh) == \
        ref_seeding.SEEDED
    seeded = manager.identity_subdir(fresh, mgr.identity)
    assert manager.snapshot(seeded) == mgr.entries()
    assert manager.read_identity(seeded) == mgr.identity
    with open(os.path.join(seeded, manager.META_FILE),
              encoding="utf-8") as fh:
        assert "transformer_warmup" in json.load(fh)["cold_seconds"]
    warm = _fake_build(manager.enable(fresh, identity=mgr.identity),
                       "transformer_warmup", "libflash_attention-0123.so")
    assert warm["cache_hit"] is True


def test_port_seeding_seeds_a_reference_export(tmp_path):
    root = str(tmp_path / "ref-node")
    saved = ref_manager._current
    ref_mgr = ref_manager.enable(root, identity="idR",
                                 configure_jax=False)
    try:
        for label in ("step", "prefill"):
            with ref_mgr.track(label):
                with open(os.path.join(ref_mgr.cache_dir,
                                       f"{label}-cache"), "w") as fh:
                    fh.write("x" * 64)
    finally:
        ref_manager._current = saved
    ref_store, port_store = RefStore(), MemoryStateStore()
    assert ref_seeding.export_cache(ref_store, "pool1", root, "node-r")
    _copy_objects(ref_store, port_store)
    fresh = str(tmp_path / "port-node")
    assert seeding.seed_cache(port_store, "pool1", fresh,
                              expected_identity="idR") == seeding.SEEDED
    seeded = manager.identity_subdir(fresh, "idR")
    assert sorted(manager.snapshot(seeded)) == ["prefill-cache",
                                                "step-cache"]
    assert manager.read_identity(seeded) == "idR"
    assert seeding.seed_cache(port_store, "pool1", fresh) == seeding.SKIP


# ------------------------ precompile_async -----------------------------

class _Harness:
    def __init__(self, fail=False):
        self.fail = fail
        self.calls = 0

    def precompile(self):
        self.calls += 1
        if self.fail:
            raise RuntimeError("nvcc failed for flash_attention.cu")
        return ["flash_attention"]


def _trace_env(monkeypatch, tmp_path):
    goodput = tmp_path / "goodput.jsonl"
    spans = tmp_path / "spans.jsonl"
    monkeypatch.setenv("SHIPYARD_GOODPUT_FILE", str(goodput))
    monkeypatch.setenv("SHIPYARD_TRACE_FILE", str(spans))
    monkeypatch.setenv("SHIPYARD_TRACE_ID", "t" * 16)
    monkeypatch.setenv("SHIPYARD_TRACE_SPAN_ID", "s" * 8)
    return goodput, spans


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_precompile_async_records_a_compile_event_and_span(monkeypatch,
                                                           tmp_path):
    goodput, spans = _trace_env(monkeypatch, tmp_path)
    manager.enable(str(tmp_path / "cache"), identity="idA")
    harness = _Harness()
    join = aot.precompile_async(harness)
    join()
    assert harness.calls == 1
    events = _lines(goodput)
    assert [(e["kind"], e["attrs"]["what"]) for e in events] == [
        ("compile", "aot_precompile")]
    assert events[0]["attrs"]["cache_hit"] is False
    assert events[0]["trace_id"] == "t" * 16
    span, = _lines(spans)
    assert span["kind"] == "compile" and span["parent_span_id"] == "s" * 8
    assert span["attrs"] == {"what": "aot_precompile",
                             "label": "train_step_aot"}
    assert aot.precompile_async(object()) is None


def test_precompile_async_logs_a_failure_and_joins(monkeypatch, tmp_path,
                                                   caplog):
    goodput, _ = _trace_env(monkeypatch, tmp_path)
    with caplog.at_level(logging.WARNING):
        join = aot.precompile_async(_Harness(fail=True))
        join()
    assert "AOT precompile failed" in caplog.text
    assert [e["attrs"]["what"] for e in _lines(goodput)] == [
        "aot_precompile"]


# ------------------- the workload, the reference's pricing --------------

_WORKLOAD = ["--device", "cpu", "--d-model", "32", "--n-layers", "1",
             "--n-heads", "2", "--d-ff", "64", "--vocab", "64",
             "--seq-len", "16", "--batch", "2", "--warmup", "1",
             "--steps", "1", "--aot-precompile"]


def _job_report(goodput, job):
    """The job's report from the reference's accounting, after checking
    the port's prices the same lines alike (each ingest consumes the
    file, so the port's reads a copy)."""
    copy = goodput.with_name(goodput.name + ".port")
    shutil.copy(goodput, copy)
    store = RefStore()
    assert ref_events.ingest_local_events(store, "pool1", str(goodput),
                                          job_id=job, task_id="t0") > 0
    report = ref_accounting.job_report(store, "pool1", job)
    port_store = MemoryStateStore()
    assert port_events.ingest_local_events(port_store, "pool1", str(copy),
                                           job_id=job, task_id="t0") > 0
    assert port_accounting.job_report(port_store, "pool1", job) == report
    return report


def test_workload_cache_misses_then_hits_in_the_references_report(
        monkeypatch, tmp_path, stand_in_nvcc, capsys):
    from batch_shipyard_tpu_torch.workloads import train_transformer
    root = tmp_path / "cache"
    goodput = tmp_path / "goodput.jsonl"
    monkeypatch.setenv("SHIPYARD_GOODPUT_FILE", str(goodput))
    assert train_transformer.main(
        _WORKLOAD + ["--compile-cache-dir", str(root)]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (ident, path), = manager.list_identity_dirs(str(root)).items()
    assert manager.read_identity(path) == ident
    assert report["warm_start"]["compile_cache"]["identity"] == ident
    assert report["warm_start"]["time_to_first_step_s"] > 0
    first = _job_report(goodput, "job1")
    assert first["compile_cache_misses"] >= 1
    assert first["compile_cache_hits"] == 0
    # A library in the identity's dir (the stand-in nvcc's), then a
    # second run: its warm-up finds the cache warm.
    proc = subprocess.run(
        [sys.executable, "-c", _BUILD_SCRIPT, str(root), ident],
        cwd=str(REPO), env=_env([stand_in_nvcc]), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    manager._current = None
    assert train_transformer.main(
        _WORKLOAD + ["--compile-cache-dir", str(root)]) == 0
    capsys.readouterr()
    second = _job_report(goodput, "job2")
    assert second["compile_cache_hits"] >= 1


# ------------------ the harnesses' precompile lists ---------------------

@pytest.mark.parametrize("flags,marker,want", [
    ({}, False, ["flash_attention"]),
    ({}, True, ["chunked_loss", "flash_attention"]),
    ({"fused_norm": True}, True,
     ["chunked_loss", "flash_attention", "fused_norm"]),
    ({"quantize_matmuls": True}, False,
     ["flash_attention", "quantization"]),
    ({"attention_fn": _attention}, False, []),
])
def test_train_harness_lists_what_its_step_launches(monkeypatch, tmp_path,
                                                    flags, marker, want):
    """TrainHarness.kernel_libraries on a card (the device is named cuda
    after the build): the attention's, the loss's under the validation
    marker, K9's with fused_norm, K10/K11's with int8; on the CPU
    nothing, and precompile() builds nothing there."""
    import torch

    from batch_shipyard_tpu_torch.ops import kernel_select
    from batch_shipyard_tpu_torch.parallel import train
    path = tmp_path / "marker.json"
    path.write_text(json.dumps({"chunked_cross_entropy": {
        "ok": marker, "backend": "cuda"}}))
    monkeypatch.setenv(kernel_select.MARKER_ENV, str(path))
    config = train.make_transformer_config(
        vocab_size=64, d_model=128, n_layers=1, n_heads=2, d_head=64,
        d_ff=64, max_seq_len=16, **flags)
    harness = train.build_transformer_train(config, 2, 16, device="cpu")
    assert harness.kernel_libraries() == []
    assert harness.precompile() == [] and _build.built == {}
    harness.device = torch.device("cuda")
    assert harness.kernel_libraries() == want


def test_vision_harnesses_list_their_models_kernels():
    from batch_shipyard_tpu_torch.models import resnet
    from batch_shipyard_tpu_torch.ops import attention
    from batch_shipyard_tpu_torch.parallel import train
    harness = train.build_resnet_train(
        resnet.ResNetConfig(num_classes=10, stage_sizes=(1, 1, 1, 1),
                            width=8), batch_size=2, device="cpu")
    assert harness.kernel_libraries() == [] == harness.precompile()
    assert harness.model.kernel_libraries() == ()
    assert attention.libraries("cuda") == ("flash_attention",)
    assert attention.libraries("cpu") == ()
