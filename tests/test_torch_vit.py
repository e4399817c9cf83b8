"""The port's ViT and DiT (models/vit.py, models/diffusion.py,
parallel/train.build_vit_train / build_diffusion_train) against the JAX
reference on the CPU, in fp32, at d_model 128 with 2 heads (head depth
64, the card's) and 2 layers.

The same perturbed flax params (models/convert.py; perturbed so that
adaLN-Zero's zero Denses and the zero biases do not hide a fault) and
numpy-seeded inputs go through both. The reference's attention runs
blockwise, as on its CPU (one block for 196 patches); the port's CPU
path is its plain blockwise softmax. At 256 patches the port's flash
path (the K1/K2 plain versions) is held against the reference's Pallas
kernels in interpret mode. DiT's loss takes the reference's own draws of
t and noise (the frameworks' generators differ), and the sampler the
reference's starting noise. Tolerances: logits, losses and samples 1e-5
relative (the alpha_bar schedule 1e-6, one fp32 ulp; DDIM samples 1e-4:
its first step scales eps's differences by 1/sqrt(alpha_bar[999]) ~ 300);
gradients within 1e-5 of each tensor's largest element; the parameters
after one AdamW step within 1e-5 absolute of optax.adamw's step on the
same (port) gradients, which the step before holds to the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.models import diffusion as jdif
from batch_shipyard_tpu.models import vit as jvit
from batch_shipyard_tpu.ops import attention as jattn
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import diffusion as tdif
from batch_shipyard_tpu_torch.models import vit as tvit
from batch_shipyard_tpu_torch.ops import attention as tattn
from batch_shipyard_tpu_torch.parallel import train as ttrain

WIDTH = dict(d_model=128, n_layers=2, n_heads=2, d_ff=256)
RTOL, PARAM_ATOL, SAMPLE_RTOL = 1e-5, 1e-5, 1e-4
LR = 1e-3  # build_vit_train's, optax.adamw(1e-3, weight_decay=0.05)
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        _np(params))


def _close(got, want, what, rtol=RTOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def _close_grads(model, grads):
    """Every gradient within RTOL of its tensor's largest element. The k
    projections' biases get zero in exact arithmetic (a bias on k shifts
    every score of a query's row alike, which the softmax ignores), so
    both frameworks give rounding noise there: it must stay below RTOL
    of the model's largest gradient element."""
    want = convert.params_from_flax(_np(grads))
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    largest = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for name in want:
        if name.endswith("k_proj.bias"):
            for g in (got[name], want[name]):
                assert float(g.abs().max()) <= RTOL * largest, name
            continue
        _close(got[name], want[name], name)


def _to_flax(tree, state):
    """The port's state dict in the flax tree's layout (the inverse of
    convert.params_from_flax)."""
    def leaf(path, value):
        keys = [k.key for k in path]
        if keys[-1] == "kernel":
            return np.asarray(state[".".join(keys[:-1] + ["weight"])]).T
        return np.asarray(state[".".join(keys)])
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _vit_case(image_size, patch, seed=0):
    cfg = jvit.ViTConfig(image_size=image_size, patch_size=patch,
                         num_classes=10, dtype=jnp.float32, **WIDTH)
    model = jvit.ViT(cfg)
    rng = np.random.RandomState(seed)
    images = rng.randn(BATCH, image_size, image_size, 3).astype(np.float32)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int32)
    params = _perturbed(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                            jnp.asarray(images))["params"],
                        seed + 1)
    return cfg, model, params, images, labels


def _port_vit(cfg, params):
    tcfg = tvit.ViTConfig(image_size=cfg.image_size,
                          patch_size=cfg.patch_size, num_classes=10,
                          dtype=torch.float32, **WIDTH)
    return ttrain.build_vit_train(tcfg, batch_size=BATCH, device="cpu",
                                  params=convert.params_from_flax(params))


def _vit_loss(model):
    def loss(p, x, y):
        return jvit.cross_entropy_loss(model.apply({"params": p}, x), y)
    return loss


def test_vit_196_patches_logits_gradients_and_adamw_step():
    cfg, model, params, images, labels = _vit_case(28, 2)
    assert cfg.num_patches == 196
    x, y = jnp.asarray(images), jnp.asarray(labels)
    want_logits = jax.jit(lambda p: model.apply({"params": p}, x))(params)
    want_loss, grads = jax.jit(jax.value_and_grad(_vit_loss(model)))(
        params, x, y)
    harness = _port_vit(cfg, params)
    xt, yt = torch.from_numpy(images), torch.from_numpy(labels)
    logits = harness.model(xt)
    _close(logits, want_logits, "logits")
    loss = tvit.cross_entropy_loss(logits, yt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    _close_grads(harness.model, grads)
    # The step against optax.adamw fed the port's own gradients (held to
    # the reference's above): Adam turns a gradient near its eps into a
    # whole lr-sized move either way, so the two frameworks' rounding in
    # such an element would show in the parameter.
    port_grads = _to_flax(params, {name: p.grad for name, p in
                                   harness.model.named_parameters()})
    optimizer = optax.adamw(LR, weight_decay=0.05)
    updates, _ = optimizer.update(port_grads, optimizer.init(params), params)
    want = convert.params_from_flax(_np(optax.apply_updates(params,
                                                            updates)))
    got = float(harness.step({"images": xt, "labels": yt})["loss"])
    np.testing.assert_allclose(got, float(want_loss), rtol=RTOL)
    for name, value in harness.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, err_msg=name)
    assert harness.optimizer_step == 1


def test_vit_adamw_state_carries_over_from_optax():
    """optax.adamw's state after one step (params, mu, nu, count) loaded
    into the port's AdamW (convert.opt_state_from_optax) takes the second
    step as optax does from the same gradients (the port's, which the
    test above holds to the reference's)."""
    cfg, model, params, images, labels = _vit_case(28, 2, seed=8)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    optimizer = optax.adamw(LR, weight_decay=0.05)
    _, grads = jax.jit(jax.value_and_grad(_vit_loss(model)))(params, x, y)
    updates, state = optimizer.update(grads, optimizer.init(params), params)
    p1 = _np(optax.apply_updates(params, updates))
    adam = state[0]
    carried = convert.opt_state_from_optax(_np(adam.mu), _np(adam.nu),
                                           adam.count)
    assert carried["step"] == 1
    harness = _port_vit(cfg, p1)
    for name, param in harness.model.named_parameters():
        harness.optimizer.state[param] = {
            "step": torch.tensor(float(carried["step"])),
            "exp_avg": carried["exp_avg"][name].clone(),
            "exp_avg_sq": carried["exp_avg_sq"][name].clone()}
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    loss = tvit.cross_entropy_loss(harness.model(batch["images"]),
                                   batch["labels"])
    loss.backward()
    port_grads = _to_flax(p1, {name: p.grad for name, p in
                               harness.model.named_parameters()})
    updates, _ = optimizer.update(port_grads, state, p1)
    want = convert.params_from_flax(_np(optax.apply_updates(p1, updates)))
    harness.step(batch)
    for name, value in harness.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   atol=PARAM_ATOL, err_msg=name)


def test_vit_pieces_match_reference():
    """sincos table, the fp32-statistics LayerNorm (eps 1e-6) and the
    tanh GELU of flax's nn.gelu."""
    np.testing.assert_array_equal(tvit.sincos_2d_positions(14, 128),
                                  jvit.sincos_2d_positions(14, 128))
    rng = np.random.RandomState(3)
    x = (5.0 + rng.randn(3, 7, 128)).astype(np.float32)
    scale, bias = rng.randn(128).astype(np.float32), rng.randn(
        128).astype(np.float32)
    want = jvit.LayerNorm(dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    norm = tvit.LayerNorm(128, torch.float32)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
    _close(norm(torch.from_numpy(x)), want, "layernorm")
    from flax import linen as nn
    _close(torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh"),
           nn.gelu(jnp.asarray(x)), "gelu")


def test_vit_256_patches_flash_path_against_interpret_mode_kernels(
        monkeypatch):
    """At 256 patches (the reference's Pallas shape) the reference's
    attention forced onto its flash kernels K1/K2 in Pallas interpret
    mode; the port's attention forced onto impl="flash" (K1/K2's plain
    versions on CPU tensors): logits and gradients."""
    cfg, model, params, images, labels = _vit_case(32, 2, seed=4)
    assert cfg.num_patches == 256
    monkeypatch.setattr(jattn, "attention", functools.partial(
        jattn.attention, impl="flash"))
    with pltpu.force_tpu_interpret_mode():
        want_loss, grads = jax.value_and_grad(_vit_loss(model))(
            params, jnp.asarray(images), jnp.asarray(labels))
    monkeypatch.setattr(tattn, "attention", functools.partial(
        tattn.attention, impl="flash"))
    harness = _port_vit(cfg, params)
    before = dict(tattn.plain_calls)
    loss = tvit.cross_entropy_loss(harness.model(torch.from_numpy(images)),
                                   torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    _close_grads(harness.model, grads)
    for key in ("flash_fwd", "flash_bwd"):
        assert tattn.plain_calls[key] - before[key] == WIDTH["n_layers"]


def _dit_case(seed=0, num_classes=10):
    cfg = jdif.DiTConfig(image_size=16, patch_size=2, num_classes=num_classes,
                         dtype=jnp.float32, **WIDTH)
    model = jdif.DiT(cfg)
    rng = np.random.RandomState(seed)
    x0 = np.tanh(rng.randn(BATCH, 16, 16, 3)).astype(np.float32)
    labels = rng.randint(0, 10, (BATCH,)).astype(np.int32)
    t0 = jnp.zeros((BATCH,), jnp.int32)
    init = jax.jit(functools.partial(model.init, labels=jnp.asarray(labels)))
    params = _perturbed(init(jax.random.PRNGKey(seed), jnp.asarray(x0),
                             t0)["params"], seed + 1)
    tcfg = tdif.DiTConfig(image_size=16, patch_size=2,
                          num_classes=num_classes, dtype=torch.float32,
                          **WIDTH)
    harness = ttrain.build_diffusion_train(
        tcfg, batch_size=BATCH, device="cpu",
        params=convert.params_from_flax(params))
    return cfg, model, params, x0, labels, harness


def test_dit_forward_loss_gradients_with_reference_draws():
    cfg, model, params, x0, labels, harness = _dit_case()
    key = jax.random.PRNGKey(7)
    # diffusion_loss's own draws (models/diffusion.py:165-178).
    t_key, n_key = jax.random.split(key)
    t = jax.random.randint(t_key, (BATCH,), 0, cfg.timesteps)
    noise = jax.random.normal(n_key, x0.shape, jnp.float32)
    lab = jnp.asarray(labels)
    want_eps = jax.jit(lambda p: model.apply({"params": p},
                                             jnp.asarray(x0), t, lab))(params)
    want_loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jdif.diffusion_loss(model, p, jnp.asarray(x0), key,
                                      lab)))(params)
    tt = torch.from_numpy(np.asarray(t))
    lt = torch.from_numpy(labels)
    _close(harness.model(torch.from_numpy(x0), tt, lt), want_eps, "eps")
    np.testing.assert_allclose(
        tdif.cosine_alpha_bar(cfg.timesteps).numpy(),
        np.asarray(jdif.cosine_alpha_bar(cfg.timesteps)), rtol=1e-6)
    loss = tdif.diffusion_loss(harness.model, torch.from_numpy(x0),
                               labels=lt, t=tt,
                               noise=torch.from_numpy(np.asarray(noise)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    _close_grads(harness.model, grads)


def test_dit_ddim_sample_from_reference_noise():
    cfg, model, params, _, labels, harness = _dit_case(seed=2)
    key = jax.random.PRNGKey(3)
    lab = jnp.asarray(labels)
    want = jdif.ddim_sample(model, params, key, BATCH, num_steps=5,
                            labels=lab)
    noise = jax.random.normal(key, (BATCH, 16, 16, 3), jnp.float32)
    got = tdif.ddim_sample(harness.model, BATCH, 5,
                           labels=torch.from_numpy(labels),
                           noise=torch.from_numpy(np.asarray(noise)))
    # The first step divides eps by sqrt(alpha_bar[999]) = 3.2e-3, which
    # scales the frameworks' fp32 differences in eps by ~300.
    _close(got, want, "samples", rtol=SAMPLE_RTOL)


def test_dit_zero_init_starts_as_identity_and_steps_draw_by_counter():
    """adaLN-Zero: a fresh DiT predicts zero noise; the harness's steps
    draw t and noise from (seed + 1, step counter), so two harnesses on
    one seed take the same steps, and a dp rank trains its rows of the
    global draw."""
    cfg = tdif.DiTConfig(image_size=8, patch_size=2, dtype=torch.float32,
                         **WIDTH)
    model = tdif.DiT(cfg)
    tdif.init_params(model, torch.Generator().manual_seed(0))
    out = model(torch.randn(2, 8, 8, 3), torch.tensor([3, 9]))
    assert torch.count_nonzero(out) == 0
    batch = {"images": torch.tanh(torch.randn(2, 8, 8, 3,
                                              generator=torch.Generator()
                                              .manual_seed(1)))}
    losses = []
    for _ in range(2):
        h = ttrain.build_diffusion_train(cfg, batch_size=2, device="cpu",
                                         seed=5)
        losses.append([float(h.step(batch)["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    g0 = ttrain.diffusion_step_generator(5, 0, "cpu")
    g1 = ttrain.diffusion_step_generator(5, 1, "cpu")
    assert not torch.equal(torch.randn(4, generator=g0),
                           torch.randn(4, generator=g1))
