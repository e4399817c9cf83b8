"""The port's front door against the reference's: each scenario of
tests/test_cli_fleet.py through both click entry points
(batch_shipyard_tpu.cli.main and batch_shipyard_tpu_torch.cli.main) on
the fake substrate and a localfs store, one configdir each, with the
--raw outputs compared after dropping times and ids; the command tree
and --version; the HelloWorld-CPU and ParametricSweep recipes through
the port's fleet (tests/test_recipes.py:44-87); pool add -> jobs add
--tail -> jobs wait --goodput-report -> pool del as processes; and the
CLI's import weight (no torch). The pools are GPU pools, which both
packages run: one slice of ``vm_count`` nodes."""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import yaml
from click.testing import CliRunner

from batch_shipyard_tpu.cli.main import cli as ref_cli
from batch_shipyard_tpu.data import movement as ref_movement
from batch_shipyard_tpu.jobs import manager as ref_jobs
from batch_shipyard_tpu.state.localfs import (
    LocalFSStateStore as RefLocalFSStateStore)
from batch_shipyard_tpu_torch import fleet
from batch_shipyard_tpu_torch.cli.main import cli as port_cli
from batch_shipyard_tpu_torch.config import settings as port_settings
from batch_shipyard_tpu_torch.data import movement as port_movement
from batch_shipyard_tpu_torch.jobs import manager as port_jobs
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore

REPO = pathlib.Path(__file__).resolve().parent.parent
RECIPES = REPO / "recipes"
CLIS = {"ref": ref_cli, "port": port_cli}
# The reference's groups this package leaves out (their modules are not
# ported): click answers "No such command".
ABSENT = {"lint", "chaos", "sim", "monitor", "fed", "slurm", "fs", "misc"}


def _pool(pool_id, nodes=2):
    return {"pool_specification": {
        "id": pool_id, "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": nodes}},
        "max_wait_time_seconds": 30}}


def _configdirs(tmp_path, confs):
    """One configdir per package, each on its own localfs store."""
    dirs = {}
    for name in CLIS:
        base = tmp_path / name
        base.mkdir()
        for kind, data in dict(confs, credentials={"credentials": {
                "storage": {"backend": "localfs",
                            "root": str(base / "store")}}}).items():
            with open(base / f"{kind}.yaml", "w") as fh:
                yaml.safe_dump(data, fh)
        dirs[name] = str(base)
    return dirs


def _both(dirs, *argv, code=0):
    """``argv`` through both CLIs: {"ref": output, "port": output}; each
    must exit ``code``."""
    out = {}
    for name, cli in CLIS.items():
        result = CliRunner().invoke(cli, ["--configdir", dirs[name],
                                          *argv])
        assert result.exit_code == code, (name, argv, result.output,
                                          result.exception)
        out[name] = result.output
    return out


def _raw(dirs, *argv):
    return {name: json.loads(text) for name, text in
            _both(dirs, "--raw", *argv).items()}


def _drop(obj, keys):
    """``obj`` without the given keys at any depth."""
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def _shape(obj):
    """The keys of ``obj`` at every depth, values' types only (times and
    durations differ between runs)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return "number" if isinstance(obj, (int, float)) else type(obj).__name__


def _groups(help_text):
    lines = help_text.split("Commands:", 1)[1].splitlines()
    return {line.split()[0] for line in lines if line.strip()}


@pytest.fixture()
def flow_dirs(tmp_path):
    return _configdirs(tmp_path, {
        "config": {"global_resources": {"docker_images": []}},
        "pool": _pool("clipool"),
        "jobs": {"job_specifications": [{
            "id": "clijob", "tasks": [{"command": "echo cli-works"}]}]}})


def test_help_lists_the_references_groups_less_the_absent_ones():
    ref = CliRunner().invoke(ref_cli, ["--help"])
    port = CliRunner().invoke(port_cli, ["--help"])
    assert ref.exit_code == port.exit_code == 0
    assert ABSENT <= _groups(ref.output)
    assert _groups(port.output) == _groups(ref.output) - ABSENT
    for group in sorted(ABSENT):
        result = CliRunner().invoke(port_cli, [group, "--help"])
        assert result.exit_code == 2 and "No such command" in \
            result.output, (group, result.output)
    quota = CliRunner().invoke(port_cli, ["account", "quota", "--help"])
    assert quota.exit_code == 0 and "--zone" in quota.output


@pytest.mark.parametrize("group", [
    "pool", "jobs", "goodput", "trace", "data", "diag", "account",
    "secrets", "storage", ("pool", "nodes"), ("pool", "cache"),
    ("pool", "user"), ("pool", "images"), ("pool", "autoscale"),
    ("jobs", "tasks"), ("data", "files"), ("diag", "logs")])
def test_each_ported_group_has_the_references_commands(group):
    """The same verbs in each ported group."""
    argv = list(group) if isinstance(group, tuple) else [group]
    ref = CliRunner().invoke(ref_cli, argv + ["--help"])
    port = CliRunner().invoke(port_cli, argv + ["--help"])
    assert ref.exit_code == port.exit_code == 0
    assert _groups(port.output) == _groups(ref.output)


def test_version():
    from batch_shipyard_tpu.version import __version__ as ref_version
    from batch_shipyard_tpu_torch.version import __version__
    result = CliRunner().invoke(port_cli, ["--version"])
    assert result.exit_code == 0
    assert __version__ == ref_version
    assert result.output.strip().endswith(f"version {__version__}")


def test_pool_jobs_flow_matches_the_reference(flow_dirs):
    _both(flow_dirs, "pool", "add")
    pools = _raw(flow_dirs, "pool", "list")
    assert _drop(pools["port"], {"created_at"}) == _drop(
        pools["ref"], {"created_at"}) == {
            "pools": [{"id": "clipool", "state": "ready"}]}
    tail = _both(flow_dirs, "jobs", "add", "--tail", "stdout.txt")
    assert tail["port"] == tail["ref"] and "cli-works" in tail["port"]
    tasks = _raw(flow_dirs, "jobs", "tasks", "list", "clijob")
    assert _drop(tasks["port"], {"trace_id", "node_id"}) == _drop(
        tasks["ref"], {"trace_id", "node_id"}) == {"tasks": [{
            "id": "task-00000", "state": "completed", "exit_code": 0}]}
    assert tasks["port"]["tasks"][0]["trace_id"]
    stats = _raw(flow_dirs, "pool", "stats")
    # Node states move as the fake agents revive in each command.
    assert _drop(stats["port"], {"by_state"}) == _drop(
        stats["ref"], {"by_state"})
    assert stats["port"]["tasks"]["completed"] == 1
    perf = _raw(flow_dirs, "diag", "perf")
    events = {name: {(e["source"], e["event"]) for e in got["events"]}
              for name, got in perf.items()}
    assert events["port"] == events["ref"]
    assert ("pool", "create.end") in events["port"]
    stream = _both(flow_dirs, "data", "stream", "clijob", "task-00000")
    assert stream["port"] == stream["ref"] and "cli-works" in \
        stream["port"]
    jobs = _raw(flow_dirs, "jobs", "list")
    assert jobs["port"] == jobs["ref"]
    job_stats = _raw(flow_dirs, "jobs", "stats", "--job-id", "clijob")
    assert _shape(job_stats["port"]) == _shape(job_stats["ref"])
    _both(flow_dirs, "pool", "del", "-y")
    assert _raw(flow_dirs, "pool", "list") == {
        "ref": {"pools": []}, "port": {"pools": []}}


def test_rejects_bad_config(tmp_path):
    out = {}
    for name, cli in CLIS.items():
        base = tmp_path / name
        base.mkdir()
        with open(base / "pool.yaml", "w") as fh:
            yaml.safe_dump({"pool_specification": {"id": "x",
                                                   "bogus": True}}, fh)
        with open(base / "credentials.yaml", "w") as fh:
            yaml.safe_dump({"credentials": {
                "storage": {"backend": "memory"}}}, fh)
        result = CliRunner().invoke(
            cli, ["--configdir", str(base), "pool", "add"])
        assert result.exit_code != 0
        out[name] = str(result.exception)
    assert "bogus" in out["port"] and out["port"] == out["ref"]


def test_pool_exists_and_tasks_count(tmp_path):
    dirs = _configdirs(tmp_path, {
        "config": {"global_resources": {"docker_images": []}},
        "pool": _pool("clip"),
        "jobs": {"job_specifications": [{
            "id": "cj", "tasks": [{"command": "echo one"},
                                  {"command": "echo two"}]}]}})
    missing = _both(dirs, "pool", "exists", code=1)
    assert missing["port"] == missing["ref"]
    _both(dirs, "pool", "add")
    present = _both(dirs, "pool", "exists")
    assert present["port"] == present["ref"]
    _both(dirs, "jobs", "add")
    for name, store_cls, jobs_mgr in (
            ("ref", RefLocalFSStateStore, ref_jobs),
            ("port", LocalFSStateStore, port_jobs)):
        store = store_cls(str(pathlib.Path(dirs[name]) / "store"))
        tasks = jobs_mgr.wait_for_tasks(store, "clip", "cj", timeout=30,
                                        poll_interval=0.1)
        assert [t["state"] for t in tasks] == ["completed"] * 2
    counts = _raw(dirs, "jobs", "tasks", "count", "cj")
    assert counts["port"] == counts["ref"]
    assert counts["port"]["total"] == 2
    assert counts["port"]["by_state"] == {"completed": 2}


def test_tasks_count_unknown_job_errors(tmp_path):
    dirs = _configdirs(tmp_path, {"pool": _pool("cx")})
    out = {}
    for name, cli in CLIS.items():
        result = CliRunner().invoke(
            cli, ["--configdir", dirs[name], "jobs", "tasks", "count",
                  "ghost"])
        assert result.exit_code != 0
        out[name] = result.output
    assert "does not exist" in out["port"] and out["port"] == out["ref"]


def test_data_ingress_filters_unready_nodes(tmp_path, monkeypatch):
    """'data ingress' with a shared-fs spec shards onto READY nodes
    only, in both packages."""
    src_dir = tmp_path / "payload"
    src_dir.mkdir()
    (src_dir / "x.bin").write_bytes(b"z" * 128)
    dirs = _configdirs(tmp_path, {
        "config": {"global_resources": {"files": [{
            "source": {"path": str(src_dir)},
            "destination": {"path": "/mnt/shared"}}]}},
        "pool": _pool("ingp", nodes=4)})
    _both(dirs, "pool", "add")
    captured = {}
    unready = {}
    for name, module, store_cls in (
            ("ref", ref_movement, RefLocalFSStateStore),
            ("port", port_movement, LocalFSStateStore)):
        store = store_cls(str(pathlib.Path(dirs[name]) / "store"))
        rows = sorted(store.query_entities(names.TABLE_NODES,
                                           partition_key="ingp"),
                      key=lambda r: r["_rk"])
        store.merge_entity(names.TABLE_NODES, "ingp", rows[0]["_rk"],
                           {"state": "start_task_failed"})
        unready[name] = (rows[0]["_rk"], len(rows))

        def fake_ingress(store_, conf, pool_id=None, node_logins=None,
                         ssh_username="shipyard", ssh_private_key=None,
                         _name=name):
            captured[_name] = sorted(n for n, _ip, _p in node_logins)
            return 0

        monkeypatch.setattr(module, "ingress_data", fake_ingress)
    _both(dirs, "data", "ingress")
    assert captured["port"] == captured["ref"]
    node_id, total = unready["port"]
    assert node_id not in captured["port"]
    assert len(captured["port"]) == total - 1


def test_goodput_and_jobs_wait_match_the_reference(tmp_path):
    from batch_shipyard_tpu.goodput import accounting as ref_accounting
    dirs = _configdirs(tmp_path, {
        "config": {"global_resources": {"docker_images": []}},
        "pool": _pool("gpool"),
        "jobs": {"job_specifications": [{
            "id": "gjob", "tasks": [{"command": "sleep 0.1 && echo done"}]
        }]}})
    _both(dirs, "pool", "add")
    _both(dirs, "jobs", "add")
    waited = _both(dirs, "jobs", "wait", "--job-id", "gjob", "--timeout",
                   "30", "--goodput-report")
    head = {name: text.split("category", 1)[0]
            for name, text in waited.items()}
    assert head["port"] == head["ref"] and "completed" in head["port"]
    rows = {name: [line.split()[0] for line in text.splitlines()
                   if line and not line.startswith("-")]
            for name, text in waited.items()}
    assert rows["port"] == rows["ref"]
    assert "goodput_ratio" in waited["port"]
    report = _raw(dirs, "goodput", "job", "gjob")
    assert _shape(report["port"]) == _shape(report["ref"])
    got = report["port"]
    assert got["job_id"] == "gjob"
    assert set(got["badput_seconds"]) == set(
        ref_accounting.BADPUT_CATEGORIES)
    total = got["productive_seconds"] + sum(got["badput_seconds"].values())
    assert total == pytest.approx(got["wall_seconds"], rel=0.01)
    for scope in (["goodput", "pool"], ["goodput", "fleet"]):
        out = _both(dirs, *scope)
        assert "goodput_ratio" in out["port"]
        assert [line.split()[0] for line in out["port"].splitlines()
                if line and line[0].isalpha()] == \
            [line.split()[0] for line in out["ref"].splitlines()
             if line and line[0].isalpha()]
    for scope in ("pool", "fleet"):
        raw = _raw(dirs, "goodput", scope)
        assert _shape(raw["port"]) == _shape(raw["ref"])


def test_trace_show_and_export_match_the_reference(flow_dirs):
    _both(flow_dirs, "pool", "add")
    _both(flow_dirs, "jobs", "add", "--tail", "stdout.txt")
    tasks = _raw(flow_dirs, "jobs", "tasks", "list", "clijob")
    shown = {}
    for name, cli in CLIS.items():
        trace_id = tasks[name]["tasks"][0]["trace_id"]
        result = CliRunner().invoke(cli, [
            "--configdir", flow_dirs[name], "--raw", "trace", "show",
            trace_id])
        assert result.exit_code == 0, result.output
        shown[name] = sorted(
            row.get("kind") or row.get("name") or ""
            for row in json.loads(result.output)["spans"])
        exported = CliRunner().invoke(cli, [
            "--configdir", flow_dirs[name], "trace", "export", trace_id])
        assert exported.exit_code == 0
        assert json.loads(exported.output)["traceEvents"]
    assert shown["port"] == shown["ref"] and shown["port"]


def test_pool_cache_and_account_info(flow_dirs, monkeypatch):
    from batch_shipyard_tpu.utils import util as ref_util
    from batch_shipyard_tpu_torch.utils import util as port_util
    _both(flow_dirs, "pool", "add")
    stats = _raw(flow_dirs, "pool", "cache", "stats")
    assert stats["port"] == stats["ref"]
    assert stats["port"]["pool_id"] == "clipool"
    pruned = _raw(flow_dirs, "pool", "cache", "prune", "-y")
    assert pruned["port"] == pruned["ref"]
    # The device probe runs in a subprocess (torch's or JAX's): stood in.
    for module in (ref_util, port_util):
        monkeypatch.setattr(module, "probe_default_devices",
                            lambda timeout=30.0: (0, None))
    info = _raw(flow_dirs, "account", "info")
    assert info["port"] == info["ref"]
    assert info["port"]["pools"] == ["clipool"]


def test_pool_autoscale_evaluate_and_tick(tmp_path):
    """`pool autoscale enable | evaluate | tick` on a GPU pool: node
    counts, the same decision from both packages."""
    pool = _pool("aspool", nodes=1)
    pool["pool_specification"]["autoscale"] = {
        "enabled": True, "formula": "3"}
    dirs = _configdirs(tmp_path, {"pool": pool})
    _both(dirs, "pool", "add")
    evaluated = _raw(dirs, "pool", "autoscale", "evaluate")
    assert evaluated["port"] == evaluated["ref"]
    assert evaluated["port"]["target_nodes"] == 3
    assert evaluated["port"]["target_slices"] is None
    _both(dirs, "pool", "autoscale", "enable")
    ticked = _raw(dirs, "pool", "autoscale", "tick")
    assert ticked["port"] == ticked["ref"] and ticked["port"]["applied"]
    counts = _raw(dirs, "pool", "nodes", "count")
    assert counts["port"]["total"] == counts["ref"]["total"] == 3


# ------------------------- recipes, processes ---------------------------

def _recipe(name):
    with open(RECIPES / name / "config" / "pool.yaml") as fh:
        pool = yaml.safe_load(fh)
    with open(RECIPES / name / "config" / "jobs.yaml") as fh:
        jobs = yaml.safe_load(fh)
    return pool, jobs


def _creds(tmp_path):
    return {"credentials": {"storage": {
        "backend": "localfs", "root": str(tmp_path / "store")}}}


def test_helloworld_recipe_runs_through_the_port(tmp_path):
    pool, jobs = _recipe("HelloWorld-CPU")
    ctx = fleet.load_context(extra={
        "credentials": _creds(tmp_path), "pool": pool, "jobs": jobs})
    try:
        fleet.action_pool_add(ctx)
        fleet.action_jobs_add(ctx)
        tasks = port_jobs.wait_for_tasks(ctx.store, "hello-pool", "hello",
                                         timeout=30)
        assert tasks[0]["state"] == "completed"
        out = port_jobs.get_task_output(ctx.store, "hello-pool", "hello",
                                        "task-00000")
        assert out.startswith(b"hello from")
    finally:
        ctx.substrate().stop_all()


def test_parametric_sweep_recipe_runs_through_the_port(tmp_path):
    """The recipe's v5litepod-8 pool (2 workers) is refused with the A3
    types named; as 2 a3-highgpu-1g nodes its sweep runs as the
    reference's does."""
    pool, jobs = _recipe("ParametricSweep")
    with pytest.raises(ValueError, match="a3-highgpu-1g"):
        port_settings.pool_settings(pool)
    spec = pool["pool_specification"]
    del spec["tpu"]
    spec["vm_configuration"] = {"vm_size": "a3-highgpu-1g",
                                "vm_count": {"dedicated": 2}}
    ctx = fleet.load_context(extra={
        "credentials": _creds(tmp_path), "pool": pool, "jobs": jobs})
    try:
        fleet.action_pool_add(ctx)
        submitted = fleet.action_jobs_add(ctx)
        assert submitted["lr-sweep"] == 6
        tasks = port_jobs.wait_for_tasks(ctx.store, "sweep-pool",
                                         "lr-sweep", timeout=30)
        assert all(t["state"] == "completed" for t in tasks)
    finally:
        ctx.substrate().stop_all()


def _cli_process(configdir, *argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "batch_shipyard_tpu_torch.cli.main",
         "--configdir", configdir, *argv], cwd=str(REPO),
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_cli_processes_run_a_job_end_to_end(tmp_path):
    """pool add -> jobs add --tail -> jobs wait --goodput-report -> pool
    del, each a process of its own (the fake substrate revives its
    agents in each)."""
    dirs = _configdirs(tmp_path, {
        "pool": _pool("procpool", nodes=1),
        "jobs": {"job_specifications": [{
            "id": "procjob", "tasks": [{"command": "echo from-a-process"}]
        }]}})
    configdir = dirs["port"]
    started = time.monotonic()
    for argv, want in ((["pool", "add"], None),
                       (["jobs", "add", "--tail", "stdout.txt"],
                        "from-a-process"),
                       (["jobs", "wait", "--job-id", "procjob",
                         "--timeout", "60", "--goodput-report"],
                        "goodput_ratio"),
                       (["pool", "del", "--yes"], None)):
        proc = _cli_process(configdir, *argv)
        assert proc.returncode == 0, (argv, proc.stdout, proc.stderr)
        if want:
            assert want in proc.stdout, (argv, proc.stdout)
    assert time.monotonic() - started < 120
    proc = _cli_process(configdir, "--raw", "pool", "list")
    assert json.loads(proc.stdout) == {"pools": []}


def test_importing_the_cli_loads_no_torch():
    script = ("import sys, batch_shipyard_tpu_torch.cli.main\n"
              "print(sorted(m for m in ('torch', 'numpy', 'jax', "
              "'batch_shipyard_tpu') if m in sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]"]


def _norm_paths(text, dirs, name):
    return text.replace(dirs[name], "<configdir>")


def test_remaining_verbs_match_the_reference(flow_dirs):
    """The other ported verbs on one pool: images, user, ssh, jobs
    profile / preempt / disable / enable / migrate / cmi / schedule,
    tasks term / del, data files, diag logs and gantt, the prunes,
    resize, suspend / start, term, del, autopool-reap, storage."""
    _both(flow_dirs, "pool", "add")
    _both(flow_dirs, "jobs", "add", "--tail", "stdout.txt")

    def same(*argv, code=0, drop=()):
        out = _both(flow_dirs, *argv, code=code)
        got = {name: _norm_paths(text, flow_dirs, name)
               for name, text in out.items()}
        if drop:
            got = {name: _drop(yaml.safe_load(text), set(drop))
                   for name, text in got.items()}
        assert got["port"] == got["ref"], (argv, got)
        return got["port"]

    assert json.loads(same("--raw", "pool", "images", "list")) == {
        "images": [], "registries": []}
    same("pool", "images", "update", "busybox")
    keys = {}
    for name, cli in CLIS.items():
        out_dir = pathlib.Path(flow_dirs[name]) / "keys"
        result = CliRunner().invoke(cli, [
            "--configdir", flow_dirs[name], "pool", "user", "add",
            "--output-dir", str(out_dir)])
        assert result.exit_code == 0, result.output
        keys[name] = _norm_paths(result.output, flow_dirs, name)
        assert (out_dir / "id_rsa_shipyard_clipool.pub").exists()
    assert keys["port"] == keys["ref"] == (
        "private key: <configdir>/keys/id_rsa_shipyard_clipool\n")
    same("pool", "user", "del")
    ssh = yaml.safe_load(same("pool", "ssh", "clipool-s0-w0"))
    assert ssh["node"] == "clipool-s0-w0" and ssh["port"] == 22
    profile = same("jobs", "profile", "clijob", "--steps", "3",
                   drop=("requested_at",))
    assert profile == {"job_id": "clijob",
                       "profile_request": {"steps": 3}}
    assert same("jobs", "preempt", "clijob", "task-00000") == \
        "job_id: clijob\ntask_id: task-00000\nrequested: false\n"
    same("jobs", "disable", "--job-id", "clijob")
    same("jobs", "enable", "--job-id", "clijob")
    migrate = {name: str(CliRunner().invoke(cli, [
        "--configdir", flow_dirs[name], "jobs", "migrate", "--job-id",
        "clijob", "--dst-pool-id", "other"]).exception)
        for name, cli in CLIS.items()}
    assert migrate["port"] == migrate["ref"] == \
        "destination pool other does not exist"
    assert same("jobs", "cmi") == "cleanup fanned out to 2 nodes\n"
    assert same("jobs", "schedule", "--once") == "launched: []\n"
    files = same("data", "files", "list", "clijob", "task-00000")
    assert "stdout.txt" in files.split()
    assert same("diag", "logs", "upload") == \
        "log upload requested on 2 nodes\n"
    gantt = _both(flow_dirs, "diag", "gantt")
    assert [line.split()[:1] for line in gantt["port"].splitlines()] == \
        [line.split()[:1] for line in gantt["ref"].splitlines()]
    assert same("trace", "prune", "--older-than-hours", "1000") == \
        "pruned 0 spans from pool clipool\n"
    assert same("goodput", "prune", "--older-than-hours", "1000") == \
        "pruned 0 events from pool clipool\n"
    same("jobs", "tasks", "term", "clijob", "task-00000")
    same("jobs", "tasks", "del", "clijob", "task-00000")
    same("jobs", "term", "--job-id", "clijob")
    same("jobs", "del", "--job-id", "clijob")
    same("jobs", "autopool-reap")
    same("pool", "resize", "3")
    assert _raw(flow_dirs, "pool", "nodes", "count")["port"][
        "total"] == 3
    nodes = _raw(flow_dirs, "pool", "nodes", "list")
    assert [n["node_id"] for n in nodes["port"]["nodes"]] == \
        [n["node_id"] for n in nodes["ref"]["nodes"]]
    same("pool", "suspend")
    same("pool", "start")
    sas = _both(flow_dirs, "storage", "sas", "some/key", code=1)
    assert sas["port"] == sas["ref"]
    same("storage", "clear", "-y")
    assert _raw(flow_dirs, "pool", "list") == {
        "ref": {"pools": []}, "port": {"pools": []}}


def test_secrets_match_the_reference(tmp_path):
    dirs = _configdirs(tmp_path, {})
    for name in CLIS:
        path = pathlib.Path(dirs[name]) / "credentials.yaml"
        creds = yaml.safe_load(path.read_text())
        creds["credentials"]["secrets"] = {
            "provider": "file", "file": str(tmp_path / f"{name}.secrets")}
        path.write_text(yaml.safe_dump(creds))
    put = _both(dirs, "secrets", "put", "secret://file/api_key",
                "--value", "s3cr3t")
    assert put["port"] == put["ref"]
    got = _both(dirs, "secrets", "get", "secret://file/api_key")
    assert got["port"] == got["ref"] == "s3cr3t\n"
    stored = _both(dirs, "secrets", "store-credentials",
                   "secret://file/creds")
    assert stored["port"] == stored["ref"]
