"""The port's ResNet (models/resnet.py, parallel/train.build_resnet_train,
workloads/train_resnet.py) against the JAX reference on the CPU.

The same flax params and batch_stats (models/convert.py) and
numpy-seeded images go through both packages in fp32, at a small
config (stage sizes (1, 1, 1, 1), width 8, 32x32 images, 10 classes).
The flax params are perturbed from their init, so that bn3's zero scale
and the zero biases do not hide a fault. Tolerance 5e-5: losses
relative, logits, gradients, batch_stats and parameters after SGD steps
within 5e-5 of each tensor's largest element. Both sides compute in fp32
and sum in other orders; batch norm's fast variance E[x^2] - E[x]^2
cancels, which amplifies fp32 rounding to the order of 1e-5 of a
tensor's largest gradient element on either side. The dp case runs two
gloo ranks of the port's harness (synced batch norm, the gradient
all-reduce) against the reference's one-device step on the global batch.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from batch_shipyard_tpu.models import resnet as jresnet
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import resnet as tresnet
from batch_shipyard_tpu_torch.parallel import mfu as tmfu
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_resnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8)
BATCH, IMAGE = 4, 32
RTOL = 5e-5
RANKS_TIMEOUT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, batch=BATCH):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, SMALL["num_classes"], (batch,)).astype(np.int32))


@pytest.fixture(scope="module")
def ref():
    """The reference model, perturbed params, its batch_stats, a batch,
    and jitted train/eval applies, grads and two SGD steps."""
    model = jresnet.ResNet(jresnet.ResNetConfig(dtype=jnp.float32, **SMALL))
    images, labels = _batch(0)
    variables = jax.jit(lambda k: model.init(k, jnp.asarray(images),
                                             train=True))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.randn(*a.shape).astype(np.float32),
        _np(variables["params"]))
    stats = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(np.float32),
        _np(variables["batch_stats"]))

    def loss_fn(p, s, x, y):
        logits, upd = model.apply({"params": p, "batch_stats": s}, x,
                                  train=True, mutable=["batch_stats"])
        return jresnet.cross_entropy_loss(logits, y), (logits,
                                                       upd["batch_stats"])

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    optimizer = optax.sgd(0.1, momentum=0.9, nesterov=True)

    @jax.jit
    def step(p, s, o, x, y):
        (loss, (_, s)), grads = grad_fn(p, s, x, y)
        updates, o = optimizer.update(grads, o, p)
        return optax.apply_updates(p, updates), s, o, loss

    eval_fn = jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))
    return dict(model=model, params=params, stats=stats, images=images,
                labels=labels, grad_fn=grad_fn, step=step,
                opt_init=optimizer.init, eval_fn=eval_fn)


def _port_state(params, stats):
    state = convert.params_from_flax(_np(params))
    state.update(convert.params_from_flax(_np(stats)))
    return state


def _harness(ref, batch=BATCH, mesh=None):
    return ttrain.build_resnet_train(
        tresnet.ResNetConfig(dtype=torch.float32, **SMALL),
        batch_size=batch, device="cpu",
        params=_port_state(ref["params"], ref["stats"]), mesh=mesh)


def _close(got, want, what):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"{what}: {err} > {RTOL} * {scale}"


def _close_state(got: dict, want: dict):
    assert set(got) == set(want)
    for name in want:
        _close(got[name], want[name], name)


def test_conv_kernels_convert_to_torch_layout(ref):
    state = convert.params_from_flax(_np(ref["params"]))
    flax_kernel = np.asarray(ref["params"]["stem_conv"]["kernel"])
    assert flax_kernel.shape == (7, 7, 3, 8)
    assert tuple(state["stem_conv.weight"].shape) == (8, 3, 7, 7)
    np.testing.assert_array_equal(state["stem_conv.weight"][5, 2, 1, 4],
                                  flax_kernel[1, 4, 2, 5])
    assert tuple(state["classifier.weight"].shape) == (10, 256)
    stats = convert.params_from_flax(_np(ref["stats"]))
    assert set(stats) == {name for name, _ in
                          _harness(ref).model.named_buffers()}


def test_train_and_eval_logits_and_batch_stats(ref):
    x = jnp.asarray(ref["images"])
    (_, (want_logits, want_stats)), _ = ref["grad_fn"](
        ref["params"], ref["stats"], x, jnp.asarray(ref["labels"]))
    model = _harness(ref).model
    logits = model(torch.from_numpy(ref["images"]), train=True)
    _close(logits, want_logits, "train logits")
    _close_state({name: b for name, b in model.named_buffers()},
                 convert.params_from_flax(_np(want_stats)))
    # Evaluation normalises with the stored statistics.
    fresh = _harness(ref).model
    _close(fresh(torch.from_numpy(ref["images"]), train=False),
           ref["eval_fn"](ref["params"], ref["stats"], x), "eval logits")


def test_gradients_match(ref):
    (want_loss, _), grads = ref["grad_fn"](
        ref["params"], ref["stats"], jnp.asarray(ref["images"]),
        jnp.asarray(ref["labels"]))
    model = _harness(ref).model
    loss = tresnet.cross_entropy_loss(
        model(torch.from_numpy(ref["images"]), train=True),
        torch.from_numpy(ref["labels"]))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    _close_state({name: p.grad for name, p in model.named_parameters()},
                 convert.params_from_flax(_np(grads)))


def test_sgd_nesterov_steps_and_optax_trace_carry_over(ref):
    """One SGD-Nesterov step against optax's; then optax's state after
    that step (params, trace, batch_stats) loaded into a fresh harness
    takes the second step as optax does (momentum in play). Each
    comparison starts from the same state: batch norm amplifies the
    frameworks' fp32 differences from step to step."""
    x, y = jnp.asarray(ref["images"]), jnp.asarray(ref["labels"])
    p, s, o = ref["params"], ref["stats"], ref["opt_init"](ref["params"])
    want = []
    for _ in range(2):
        p, s, o, loss = ref["step"](p, s, o, x, y)
        want.append((p, s, o, float(loss)))
    batch = {"images": torch.from_numpy(ref["images"]),
             "labels": torch.from_numpy(ref["labels"])}
    harness = _harness(ref)
    np.testing.assert_allclose(float(harness.step(batch)["loss"]),
                               want[0][3], rtol=RTOL)
    _close_state(harness.state_dict(), _port_state(*want[0][:2]))
    assert harness.optimizer_step == 1
    p1, s1, o1, _ = want[0]
    trace = convert.params_from_flax(_np(o1[0].trace))
    resumed = ttrain.build_resnet_train(
        tresnet.ResNetConfig(dtype=torch.float32, **SMALL),
        batch_size=BATCH, device="cpu", params=_port_state(p1, s1))
    for name, param in resumed.model.named_parameters():
        resumed.optimizer.state[param]["momentum_buffer"] = \
            trace[name].clone()
    np.testing.assert_allclose(float(resumed.step(batch)["loss"]),
                               want[1][3], rtol=RTOL)
    _close_state(resumed.state_dict(), _port_state(*want[1][:2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_is_flax_batch_norm(dtype):
    """One BatchNorm layer against flax's nn.BatchNorm(momentum=0.9) on
    the same input: output, biased running variance, fp32 statistics
    under a bf16 activation (output within one bf16 rounding)."""
    from flax import linen as nn
    rng = np.random.RandomState(2)
    x = (3.0 + 2.0 * rng.randn(6, 5, 5, 7)).astype(np.float32)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      dtype=jdtype)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x, jdtype))
    scale = rng.randn(7).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    y, upd = bn.apply({"params": params,
                       "batch_stats": variables["batch_stats"]},
                      jnp.asarray(x, jdtype), mutable=["batch_stats"])
    port = tresnet.BatchNorm(7, tdtype)
    with torch.no_grad():
        port.scale.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(tdtype).permute(0, 3, 1, 2)
    got = port(xt, train=True).detach().permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(jnp.asarray(y, jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())
    for key in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, key).numpy(),
            np.asarray(upd["batch_stats"][key]), rtol=1e-5)
    # The running variance is the biased one (torch's BatchNorm2d keeps
    # the unbiased one).
    xs = torch.from_numpy(x).to(tdtype).float()
    biased = xs.var(dim=(0, 1, 2), unbiased=False)
    np.testing.assert_allclose(port.var.numpy(), 0.9 + 0.1 * biased.numpy(),
                               rtol=1e-5)


def test_bn3_scale_starts_at_zero_and_projection_only_where_shapes_differ():
    model = tresnet.ResNet(tresnet.ResNetConfig(dtype=torch.float32,
                                                **SMALL))
    tresnet.init_params(model, torch.Generator().manual_seed(0))
    assert model.stage0_block0.project  # width 8 -> 32 channels
    for name in model.block_names:
        block = getattr(model, name)
        assert torch.count_nonzero(block.bn3.scale) == 0
    deep = tresnet.ResNet(tresnet.ResNetConfig(
        dtype=torch.float32, num_classes=10, stage_sizes=(2, 1, 1, 1),
        width=8))
    assert deep.stage0_block0.project and not deep.stage0_block1.project
    assert not hasattr(deep.stage0_block1, "proj_conv")
    assert len(tresnet.resnet50(dtype=torch.float32).batch_norms()) == 53


def test_resnet50_flops_match_reference():
    from batch_shipyard_tpu.parallel import mfu as jmfu
    for size in (224, 128, 32):
        assert tmfu.resnet50_train_flops_per_image(size) == \
            jmfu.resnet50_train_flops_per_image(size)


# A rank of the dp check: the same flax weights on both ranks, its rows
# of the global batch, one SGD step; the losses, state and ring calls
# saved.
DP_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.models import resnet
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import train
from batch_shipyard_tpu_torch.workloads import distributed
out = sys.argv[1]
small = eval(sys.argv[2])
distributed.setup("cpu")
mesh = mesh_mod.RankMesh.build("cpu")
data = np.load(os.path.join(out, "batch.npz"))
harness = train.build_resnet_train(
    resnet.ResNetConfig(dtype=torch.float32, **small),
    batch_size=len(data["labels"]), device="cpu",
    params=torch.load(os.path.join(out, "params.pt")), mesh=mesh)
rows = {key: torch.from_numpy(train.local_rows(harness, data[key]))
        for key in ("images", "labels")}
loss = float(harness.step(rows)["loss"])
torch.save({"loss": loss, "state": harness.state_dict(),
            "sync_calls": dict(resnet.sync_calls),
            "grad_all_reduces": harness.grad_all_reduces,
            "row0": harness.row0},
           os.path.join(out, f"rank{mesh.rank}.pt"))
mesh.close()
"""


def test_dp_two_ranks_match_reference_step_on_global_batch(ref, tmp_path):
    """Two gloo ranks of two rows each (synced batch norm: the statistics
    and the backward's two sums all-reduced, then one gradient
    all-reduce) against the reference's one-device step on all four
    rows: loss, parameters and batch_stats."""
    x, y = jnp.asarray(ref["images"]), jnp.asarray(ref["labels"])
    p, s, _, loss = ref["step"](ref["params"], ref["stats"],
                                ref["opt_init"](ref["params"]), x, y)
    torch.save(_port_state(ref["params"], ref["stats"]),
               tmp_path / "params.pt")
    np.savez(tmp_path / "batch.npz", images=ref["images"],
             labels=ref["labels"])
    runs = distributed.launch_local(
        [sys.executable, "-c", DP_WORKER, str(tmp_path), repr(SMALL)],
        nprocs=2, timeout_s=RANKS_TIMEOUT_S, cwd=REPO)
    for run in runs:
        assert run["returncode"] == 0, run["stderr"][-3000:]
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    n_bn = len(_harness(ref).model.batch_norms())
    want = _port_state(p, s)
    for rank, got in enumerate(ranks):
        assert got["row0"] == 2 * rank
        np.testing.assert_allclose(got["loss"], float(loss), rtol=RTOL)
        assert got["sync_calls"] == {"bn_stats": n_bn, "bn_grads": n_bn}
        assert got["grad_all_reduces"] == 1
        _close_state(got["state"], want)
        for name, value in got["state"].items():  # replicas bit-equal
            assert torch.equal(value, ranks[0]["state"][name]), name


def _run_workload(capsys, argv):
    rc = train_resnet.main(["--device", "cpu", "--image-size", "32",
                            "--num-classes", "10", "--batch-per-device",
                            "2", *argv])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, lines, json.loads(lines[-1])


@pytest.mark.parametrize("data", ["synthetic", "shards"])
def test_train_resnet_cpu_prints_summary_line(capsys, tmp_path, data):
    """The synthetic batch, or .npz shards through the loader (prefetch,
    uint8 normalised where the batch lies)."""
    flags = ["--steps", "2", "--warmup", "1"]
    if data == "shards":
        from batch_shipyard_tpu_torch.data import loader
        loader.write_synthetic_imagenet_shards(str(tmp_path), 2, 3, IMAGE,
                                               num_classes=10)
        flags += ["--data-dir", str(tmp_path)]
    rc, lines, report = _run_workload(capsys, flags)
    assert rc == 0
    match = re.search(r"resnet50: ([\d.]+) img/s total, ([\d.]+) "
                      r"img/s/chip, loss=([\d.]+), ([\d.]+) ms/step",
                      lines[-2])
    assert match, lines[-2]
    assert report["model"] == "resnet50" and report["batch"] == 2
    assert len(report["losses"]) == 3
    assert all(np.isfinite(report["losses"]))
    assert report["mfu_pct"] is None  # no card, no peak
    assert report["ring_calls_per_step"] == {"bn_stats": 0.0,
                                             "bn_grads": 0.0, "grads": 0.0}


def test_train_resnet_resume_matches_bit_for_bit(capsys, tmp_path):
    """Three steps at once, and two then one resumed from the checkpoint:
    the same parameters bit for bit. The checkpoint holds the parameters
    and SGD's momentum, not the running statistics (the reference saves
    no batch_stats)."""
    flags = ["--warmup", "0", "--checkpoint-dir"]
    _, _, whole = _run_workload(capsys, ["--steps", "3", *flags,
                                         str(tmp_path / "a")])
    _run_workload(capsys, ["--steps", "2", *flags, str(tmp_path / "b")])
    rc, lines, resumed = _run_workload(capsys, ["--steps", "1", *flags,
                                                str(tmp_path / "b")])
    assert rc == 0 and any("resumed from step 2" in line for line in lines)
    assert resumed["start_step"] == 2 and resumed["end_step"] == 3
    assert resumed["per_rank"][0]["params_sha256"] == \
        whole["per_rank"][0]["params_sha256"]
    assert resumed["losses"][-1] == whole["losses"][-1]
    with open(tmp_path / "b" / "step_00000003" / "layout.json") as fh:
        layout = json.load(fh)
    assert {rec["kind"] for rec in layout["records"]} == {
        "param", "momentum_buffer"}
    assert not any(t["name"].endswith((".mean", ".var"))
                   for t in layout["tensors"])


@pytest.mark.parametrize("workload", ["train_resnet", "train_vit",
                                      "train_diffusion"])
def test_vision_cli_refuses_without_cuda(workload):
    """The three vision workloads run on the card unless --device cpu is
    given: on a host without CUDA they exit nonzero, naming the flag."""
    import subprocess
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the refusal needs a CPU host")
    proc = subprocess.run(
        [sys.executable, "-m",
         f"batch_shipyard_tpu_torch.workloads.{workload}",
         "--batch-per-device", "1", "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_vision_builders_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (ttrain.build_resnet_train, ttrain.build_vit_train,
                  ttrain.build_diffusion_train):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(batch_size=1)
