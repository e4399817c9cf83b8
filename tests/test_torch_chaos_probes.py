"""The drills' two probes, the reference's and the port's, run as
subprocesses with the same argv and SHIPYARD_* environment in separate
temp dirs: the same step ledger, state, COMMITTED marker, shard files,
.LAYOUT, .reads.log and .loss.log byte for byte, the same exit code
after a preempt request, the same kinds of goodput events and the same
scheduling hints; and importing either port probe loads no torch (a
probe runs once per gang instance per attempt)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = {"reference": "batch_shipyard_tpu",
            "port": "batch_shipyard_tpu_torch"}
PROBE_TIMEOUT_S = 60


def _env(work: pathlib.Path, instance: int = 0, instances: int = 1,
         preempt: bool = False) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SHIPYARD_")}
    env.update(PYTHONPATH=str(REPO),
               SHIPYARD_TASK_INSTANCE=str(instance),
               SHIPYARD_TASK_INSTANCES=str(instances),
               SHIPYARD_PROGRESS_FILE=str(work / f"beat{instance}"),
               SHIPYARD_GOODPUT_FILE=str(work / f"goodput{instance}.jsonl"),
               SHIPYARD_SCHED_HINTS_FILE=str(work / f"hints{instance}.json"),
               SHIPYARD_PREEMPT_REQUEST_FILE=str(
                   work / f"preempt{instance}.json"))
    if preempt:
        (work / f"preempt{instance}.json").write_text(json.dumps(
            {"reason": "probe test", "requested_at": "2026-01-01T00:00:00Z"}))
    return env


def _start(package: str, probe: str, work: pathlib.Path, argv: list,
           **env_kwargs) -> subprocess.Popen:
    ckpt = work / "ckpt" / "state.json"
    ckpt.parent.mkdir(exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", f"{package}.workloads.{probe}",
         *argv, "--ckpt", str(ckpt)],
        env=_env(work, **env_kwargs), cwd=str(work),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _wait(proc: subprocess.Popen) -> int:
    out, _ = proc.communicate(timeout=PROBE_TIMEOUT_S)
    assert proc.returncode in (0, 75), out.decode(errors="replace")
    return proc.returncode


def _files(work: pathlib.Path) -> dict:
    """Every file the probes wrote beside the checkpoint, by name. The
    read log's lines come from instances running side by side, so its
    order is the scheduler's: they are compared sorted."""
    ckpt_dir = work / "ckpt"
    files = {p.name: p.read_bytes() for p in sorted(ckpt_dir.iterdir())}
    for name in files:
        if name.endswith(".reads.log"):
            files[name] = b"".join(sorted(files[name].splitlines(True)))
    return files


def _goodput_kinds(work: pathlib.Path) -> list:
    kinds = []
    for path in sorted(work.glob("goodput*.jsonl")):
        kinds.append([json.loads(line)["kind"]
                      for line in path.read_text().splitlines() if line])
    return kinds


def _hints(work: pathlib.Path) -> list:
    out = []
    for path in sorted(work.glob("hints*.json")):
        hints = json.loads(path.read_text())
        out.append({k: v for k, v in hints.items()
                    if k not in ("updated_at", "at", "ts")})
    return out


def _run_both(tmp_path, run):
    """``run(package, work)`` for each package in its own dir; returns
    {name: (its result, the files, goodput kinds, hints)}."""
    results = {}
    for name, package in PACKAGES.items():
        work = tmp_path / name
        work.mkdir()
        results[name] = (run(package, work), _files(work),
                         _goodput_kinds(work), _hints(work))
    return results


def _agree(results):
    ref, port = results["reference"], results["port"]
    assert port[0] == ref[0]
    assert sorted(port[1]) == sorted(ref[1])
    for name in ref[1]:
        assert port[1][name] == ref[1][name], name
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    return port


@pytest.mark.parametrize("argv", [
    ["--steps", "6", "--step-seconds", "0.01"],
    ["--steps", "9", "--step-seconds", "0.01", "--checkpoint-every", "2"],
    ["--steps", "4", "--step-seconds", "0.01", "--cache-identity",
     "drill-warm"],
], ids=["plain", "cadenced", "cache-identity"])
def test_preempt_probe_runs_alike(tmp_path, argv):
    got = _agree(_run_both(tmp_path, lambda pkg, work: _wait(
        _start(pkg, "preempt_probe", work, argv))))
    assert got[0] == 0
    steps = int(argv[1])
    assert got[1]["state.json.steps.log"] == \
        f"i0 0..{steps} completed\n".encode()
    assert json.loads(got[1]["state.json"]) == {"step": steps}
    assert got[1]["state.json.COMMITTED"] == str(steps).encode()
    assert got[2] == [["step_window"]]


def test_preempt_probe_drains_on_a_request_and_resumes(tmp_path):
    def run(pkg, work):
        first = _wait(_start(pkg, "preempt_probe", work,
                             ["--steps", "8", "--step-seconds", "0.01"],
                             preempt=True))
        # The agent removes a delivered request before the rerun.
        (work / "preempt0.json").unlink()
        second = _wait(_start(pkg, "preempt_probe", work,
                              ["--steps", "8", "--step-seconds", "0.01"]))
        return first, second
    got = _agree(_run_both(tmp_path, run))
    assert got[0] == (75, 0)
    assert got[1]["state.json.steps.log"] == \
        b"i0 0..1 preempted\ni0 1..8 completed\n"


def test_preempt_probe_ignoring_the_notice(tmp_path):
    got = _agree(_run_both(tmp_path, lambda pkg, work: _wait(_start(
        pkg, "preempt_probe", work,
        ["--steps", "6", "--step-seconds", "0.01", "--checkpoint-every",
         "2", "--ignore-notice"], preempt=True))))
    assert got[0] == 0
    assert got[1]["state.json.steps.log"] == \
        b"i0 0..1 notice-ignored\ni0 0..6 completed\n"


def test_preempt_probe_non_writer_leaves_the_state(tmp_path):
    got = _agree(_run_both(tmp_path, lambda pkg, work: _wait(_start(
        pkg, "preempt_probe", work,
        ["--steps", "3", "--step-seconds", "0.01"],
        instance=1, instances=2, preempt=True))))
    assert got[0] == 75
    assert got[1] == {}


def _gang(pkg, work, instances, argv, preempt=False):
    procs = [_start(pkg, "reshard_probe", work, argv, instance=i,
                    instances=instances, preempt=preempt)
             for i in range(instances)]
    return tuple(_wait(p) for p in procs)


@pytest.mark.parametrize("first,second", [(2, 1), (1, 2), (2, 4), (4, 2),
                                          (3, 4)])
def test_reshard_probe_resizes_alike(tmp_path, first, second):
    """A gang of ``first`` commits at its cadence and its end; a gang of
    ``second`` resumes: the same shards, layout, marker, planned reads
    and losses in both packages."""
    def run(pkg, work):
        return (_gang(pkg, work, first,
                      ["--steps", "10", "--step-seconds", "0.01",
                       "--dim", "24", "--checkpoint-every", "5"]),
                _gang(pkg, work, second,
                      ["--steps", "14", "--step-seconds", "0.01",
                       "--dim", "24", "--checkpoint-every", "5"]))
    got = _agree(_run_both(tmp_path, run))
    assert got[0] == ((0,) * first, (0,) * second)
    files = got[1]
    assert json.loads(files["state.json.COMMITTED"]) == {"step": 14}
    assert json.loads(files["state.json.LAYOUT"]) == {
        "step": 14, "parts": second, "dim": 24}
    reads = files["state.json.reads.log"].decode().splitlines()
    assert reads and all("step=10" in line for line in reads)
    assert {f"state.json.s14.shard{k}of{second}"
            for k in range(second)} <= set(files)
    assert not any(name.startswith("state.json.s5.") for name in files)


def test_reshard_probe_drains_on_a_request(tmp_path):
    def run(pkg, work):
        return _gang(pkg, work, 2,
                     ["--steps", "10", "--step-seconds", "0.01",
                      "--dim", "8", "--checkpoint-every", "0"],
                     preempt=True)
    got = _agree(_run_both(tmp_path, run))
    assert got[0] == (75, 75)
    assert json.loads(got[1]["state.json.COMMITTED"]) == {"step": 1}
    assert got[1]["state.json.loss.log"] == b"step=1 size=2 loss=10.000000\n"


@pytest.mark.parametrize("probe", ["preempt_probe", "reshard_probe"])
def test_port_probe_loads_no_torch(probe):
    code = (f"import sys; import batch_shipyard_tpu_torch.workloads.{probe}; "
            "print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, check=True,
                         timeout=PROBE_TIMEOUT_S)
    assert out.stdout.split() == ["False", "False"]
