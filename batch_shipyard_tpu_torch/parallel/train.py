"""Single-device transformer training: model + AdamW -> a train step.

Counterpart of batch_shipyard_tpu/parallel/train.py's
``build_transformer_train`` for one card. The reference jit-compiles a
global-view SPMD step over a mesh; the port runs the same step eagerly
on one device:

    hidden = TransformerLM(tokens, return_hidden=True)
    loss = lm_loss_chunked(hidden, embed.embedding, targets)
    AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)

The optimizer matches ``optax.adamw(3e-4, weight_decay=0.01)``: one
parameter group, so every leaf decays (the RMSNorm scales and the
embedding included), with the decay applied to the pre-update
parameter. On a CUDA device the model's attention is the flash kernels
K1 (forward) and K2 (backward); with ``fused_norm`` its norm-projections
are K9; with ``quantize_matmuls`` its projections quantize both operands
to int8 (K10) and multiply them on the int8 tensor cores (K11), with a
full-precision fp32 backward; the loss's ``auto`` takes the fused
cross-entropy kernels K3-K5 where the validation marker records them
(ops/kernel_select). Meshes (dp/fsdp/tp/sp/ep), MoE and AOT
precompilation are not ported yet.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as tfm


class TrainHarness:
    """A model and its AdamW state on one device. ``step(batch)`` runs
    one forward, backward and optimizer update and returns
    ``{"loss": 0-d tensor}`` without waiting for the device (``float``
    of the loss syncs)."""

    def __init__(self, model: tfm.TransformerLM,
                 optimizer: torch.optim.Optimizer, batch_size: int,
                 seq_len: int, loss_impl: str = "auto") -> None:
        self.model = model
        self.optimizer = optimizer
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.loss_impl = loss_impl
        self.device = model.embed.embedding.device

    def loss_fn(self, tokens, targets):
        hidden = self.model(tokens, return_hidden=True)
        return tfm.lm_loss_chunked(hidden, self.model.embed.embedding,
                                   targets, impl=self.loss_impl)

    def step(self, batch: Mapping) -> dict:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        targets = torch.as_tensor(batch["targets"], device=self.device)
        want = (self.batch_size, self.seq_len)
        if tuple(tokens.shape) != want or tuple(targets.shape) != want:
            raise ValueError(
                f"batch of {tuple(tokens.shape)} tokens and "
                f"{tuple(targets.shape)} targets; the harness was built "
                f"for {want}")
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(tokens, targets)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach()}


def make_transformer_config(sp: int = 1,
                            **overrides) -> tfm.TransformerConfig:
    """A TransformerConfig for single-device training; ``overrides``
    (``fused_norm`` and ``quantize_matmuls`` among them) pass through.
    ``sp > 1`` (ring attention over a sequence-parallel mesh axis) is not
    ported yet."""
    if sp > 1:
        raise NotImplementedError(
            "sp > 1 runs ring attention over a sequence-parallel mesh, "
            "which the port does not have yet (ROADMAP queue 1)")
    return tfm.TransformerConfig(**overrides)


def build_transformer_train(config: tfm.TransformerConfig,
                            batch_size: int, seq_len: int,
                            learning_rate: float = 3e-4, seed: int = 0,
                            device=None,
                            params: Optional[Mapping] = None,
                            loss_impl: str = "auto") -> TrainHarness:
    """The model on ``device`` (cuda unless "cpu" is named) with
    ``params`` (a state dict, e.g. models.convert.params_from_flax) or
    weights drawn from ``seed`` (convert.init_params), and AdamW.
    ``loss_impl``: lm_loss_chunked's impl ('auto', 'kernel' or
    'plain')."""
    if config.decode:
        raise ValueError("training needs decode=False")
    device = resolve_device(device)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = convert.init_params(config, generator)
    model = tfm.TransformerLM(config, device="meta")
    model.load_state_dict({name: t.to(device, copy=True)
                           for name, t in params.items()}, assign=True)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.01)
    return TrainHarness(model.train(), optimizer, batch_size, seq_len,
                        loss_impl)
