"""The port stands alone: no module of batch_shipyard_tpu_torch loads
jax, flax or any batch_shipyard_tpu module, and its entry points raise
instead of running on the CPU when no device is named on a host without
CUDA. The import check runs in a subprocess because tests/conftest.py
imports jax into every test process."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "batch_shipyard_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")
# The port's own copies of the process-side pool hooks and its checkpoint
# layer: each must be scanned and imported like the rest.
HOOK_MODULES = (
    "batch_shipyard_tpu_torch.agent.preemption",
    "batch_shipyard_tpu_torch.agent.progress",
    "batch_shipyard_tpu_torch.goodput.events",
    "batch_shipyard_tpu_torch.trace.context",
    "batch_shipyard_tpu_torch.trace.spans",
    "batch_shipyard_tpu_torch.trace.profiling",
    "batch_shipyard_tpu_torch.parallel.restore_plan",
    "batch_shipyard_tpu_torch.workloads.checkpoint",
    # The serving tier's: the fleet router, the SLO settings, the
    # diurnal curve.
    "batch_shipyard_tpu_torch.models.router",
    "batch_shipyard_tpu_torch.config.slo",
    "batch_shipyard_tpu_torch.sim.traces",
    # The warm start and the store under the hooks' store-backed halves.
    "batch_shipyard_tpu_torch.compilecache.manager",
    "batch_shipyard_tpu_torch.compilecache.aot",
    "batch_shipyard_tpu_torch.compilecache.seeding",
    "batch_shipyard_tpu_torch.state.base",
    "batch_shipyard_tpu_torch.state.memory",
    "batch_shipyard_tpu_torch.state.names",
    "batch_shipyard_tpu_torch.trace.export",
    # The node side: pool add -> jobs add -> a node agent runs the task.
    "batch_shipyard_tpu_torch.utils.util",
    "batch_shipyard_tpu_torch.utils.secrets",
    "batch_shipyard_tpu_torch.config.settings",
    "batch_shipyard_tpu_torch.parallel.topology",
    "batch_shipyard_tpu_torch.state.leases",
    "batch_shipyard_tpu_torch.state.localfs",
    "batch_shipyard_tpu_torch.state.factory",
    "batch_shipyard_tpu_torch.sched.policy",
    "batch_shipyard_tpu_torch.agent.perf",
    "batch_shipyard_tpu_torch.agent.cascade",
    "batch_shipyard_tpu_torch.agent.nodeprep",
    "batch_shipyard_tpu_torch.agent.task_runner",
    "batch_shipyard_tpu_torch.agent.node_agent",
    "batch_shipyard_tpu_torch.agent.__main__",
    "batch_shipyard_tpu_torch.data.movement",
    "batch_shipyard_tpu_torch.jobs.launcher",
    "batch_shipyard_tpu_torch.jobs.task_factory",
    "batch_shipyard_tpu_torch.jobs.expansion",
    "batch_shipyard_tpu_torch.jobs.manager",
    "batch_shipyard_tpu_torch.substrate.base",
    "batch_shipyard_tpu_torch.substrate.fakepod",
    "batch_shipyard_tpu_torch.substrate.localhost",
    "batch_shipyard_tpu_torch.pool.manager",
    # The front door: the CLI, the fleet layer and what they call.
    "batch_shipyard_tpu_torch.version",
    "batch_shipyard_tpu_torch.config.validator",
    "batch_shipyard_tpu_torch.utils.auth",
    "batch_shipyard_tpu_torch.utils.crypto",
    "batch_shipyard_tpu_torch.goodput.accounting",
    "batch_shipyard_tpu_torch.graph.perf_graph",
    "batch_shipyard_tpu_torch.jobs.schedules",
    "batch_shipyard_tpu_torch.pool.autoscale",
    "batch_shipyard_tpu_torch.fleet",
    "batch_shipyard_tpu_torch.cli.main",
    "batch_shipyard_tpu_torch.cli.docsgen",
    # The cloud pool: the ride-through, the GCS store, the A3 VM
    # substrate and what it stands on.
    "batch_shipyard_tpu_torch.state.resilient",
    "batch_shipyard_tpu_torch.state.gcs",
    "batch_shipyard_tpu_torch.substrate.gcloud_errors",
    "batch_shipyard_tpu_torch.substrate.gce_vm",
    "batch_shipyard_tpu_torch.substrate.quota",
    "batch_shipyard_tpu_torch.substrate.gcp_gpu",
    # Chaos: the plans, injectors and drills, the two probes the drills
    # launch, and the serving drills.
    "batch_shipyard_tpu_torch.chaos",
    "batch_shipyard_tpu_torch.chaos.plan",
    "batch_shipyard_tpu_torch.chaos.injectors",
    "batch_shipyard_tpu_torch.chaos.drill",
    "batch_shipyard_tpu_torch.chaos.serving_drill",
    "batch_shipyard_tpu_torch.workloads.preempt_probe",
    "batch_shipyard_tpu_torch.workloads.reshard_probe",
)
# Modules that must load no torch: the CLI's front door, the fakepod
# drills (stdlib pools and probes) and the probes a gang task runs.
TORCH_FREE = (
    "batch_shipyard_tpu_torch.cli.main",
    "batch_shipyard_tpu_torch.chaos",
    "batch_shipyard_tpu_torch.chaos.drill",
    "batch_shipyard_tpu_torch.chaos.serving_drill",
    "batch_shipyard_tpu_torch.workloads.preempt_probe",
    "batch_shipyard_tpu_torch.workloads.reshard_probe",
)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def _is_reference(name: str) -> bool:
    """batch_shipyard_tpu or a submodule — NOT batch_shipyard_tpu_torch,
    which merely shares the prefix."""
    return name == "batch_shipyard_tpu" or name.startswith(
        "batch_shipyard_tpu.")


def test_importing_every_port_module_loads_no_jax_or_reference():
    modules = [name for name, _ in _port_modules()]
    script = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of these fails\n"
        "import importlib\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('\\n'.join(sorted(name for name, mod in sys.modules.items()\n"
        "                        if mod is not None)))\n")
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = proc.stdout.split()
    assert "batch_shipyard_tpu_torch.models.server" in loaded
    assert set(HOOK_MODULES) <= set(loaded)
    bad = [m for m in loaded
           if _is_reference(m) or m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_port_sources_import_nothing_of_jax_or_the_reference():
    """Static scan of every import statement in the package, including
    imports inside functions."""
    offenders = []
    for name, path in _port_modules():
        tree = ast.parse(path.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                targets = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                targets = [node.module or ""]
            else:
                continue
            for target in targets:
                if target.split(".")[0] in FORBIDDEN or \
                        _is_reference(target):
                    offenders.append((name, target))
    assert not offenders, offenders
    scanned = {name for name, _ in _port_modules()}
    assert len(scanned) >= 14 and set(HOOK_MODULES) <= scanned


def test_entry_points_refuse_cpu_unless_named(monkeypatch):
    """ContinuousBatcher, build_transformer_train and resolve_device
    raise without CUDA unless device='cpu' is passed; the CLIs (default
    --device cuda) exit nonzero with that error."""
    from batch_shipyard_tpu_torch.device import resolve_device
    from batch_shipyard_tpu_torch.models import convert, serving
    from batch_shipyard_tpu_torch.models import transformer as tfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    cfg = tfm.TransformerConfig(vocab_size=16, d_model=16, n_layers=1,
                                n_heads=2, d_head=8, d_ff=32,
                                dtype=torch.float32)
    params = convert.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.ContinuousBatcher(cfg, params, num_slots=1,
                                  max_decode_len=16)
    from batch_shipyard_tpu_torch.parallel import train
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.build_transformer_train(cfg, batch_size=1, seq_len=4,
                                      params=params)


def test_serve_cli_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a CPU host")
    proc = subprocess.run(
        [sys.executable, "-m", "batch_shipyard_tpu_torch.workloads.serve",
         "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
         "--d-ff", "32", "--vocab", "16", "--loadgen", "1", "--port",
         "0", "--report", os.devnull],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_train_cli_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a CPU host")
    proc = subprocess.run(
        [sys.executable, "-m",
         "batch_shipyard_tpu_torch.workloads.train_transformer",
         "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
         "--d-ff", "32", "--vocab", "16", "--seq-len", "8", "--batch",
         "1", "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


@pytest.mark.parametrize("module", TORCH_FREE)
def test_torch_free_modules_load_no_torch(module):
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys, {module}; print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "False"


def test_chaos_serving_drill_cli_refuses_without_cuda():
    """`chaos drill --serve-kill` with no card visible and no --device
    exits nonzero with the device error; the fakepod drills need none."""
    proc = subprocess.run(
        [sys.executable, "-m", "batch_shipyard_tpu_torch.cli.main",
         "chaos", "drill", "--serve-kill"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO),
                 CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr + proc.stdout
