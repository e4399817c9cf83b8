"""ResNet-50 in PyTorch: the headline workload (bench_resnet, the
BASELINE metric "ResNet-50 images/sec/chip").

Counterpart of batch_shipyard_tpu/models/resnet.py, with its names
(``stem_conv``, ``stem_bn``, ``stage{s}_block{b}.conv1`` ... ``proj_bn``,
``classifier``) so that models/convert.py carries flax trees across.
Images arrive as [B, H, W, 3], as in the reference; the network runs in
``channels_last`` (``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is
already that layout, so nothing is copied), convolutions in ``dtype``
(bf16: cuDNN on the card), the global mean pool in ``dtype`` and the
classifier in fp32, as the reference's boundaries are.

Batch norm reproduces flax's ``BatchNorm`` (flax 0.12.3
``linen/normalization._compute_stats`` and ``_normalize``) and not
torch's ``BatchNorm2d``:

- statistics in fp32 whatever the activation dtype, the fast variance
  E[x^2] - E[x]^2 clipped at 0;
- the running average ``0.9 * old + 0.1 * batch`` of the batch mean and
  the **biased** batch variance (BatchNorm2d keeps the unbiased one);
- eps 1e-5; the normalisation in fp32, cast to ``dtype``;
- ``bn3``'s scale initialised to zeros, the projection shortcut only
  where the shapes differ.

Synced batch norm (``BatchNorm.group``: a data RingGroup of
parallel/mesh.py, set by parallel/train.build_resnet_train). The
reference shards the batch over every device under SPMD jit, so its
statistics are those of the global batch. Here each rank sums its rows'
per-channel sum and sum of squares (fp32), all-reduces the two over the
ring (ops/ring_collectives.ring_all_reduce: K14 then K13 on the card)
and normalises with the global mean and variance; the backward
all-reduces the two per-channel sums it needs, sum(dy) and
sum(dy * xhat), before it forms dx. Without them dp agrees on the
forward and parts on the update. ``sync_calls`` counts these ring calls
("bn_stats" in the forward, "bn_grads" in the backward).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from batch_shipyard_tpu_torch.models.transformer import lecun_normal_
from batch_shipyard_tpu_torch.ops import ring_collectives

BN_MOMENTUM = 0.9
BN_EPS = 1e-5
# The synced batch norm's ring calls so far, by label.
sync_calls = {"bn_stats": 0, "bn_grads": 0}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    num_classes: int = 1000
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    dtype: torch.dtype = torch.bfloat16


_DIMS = (0, 2, 3)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


class _BatchNormTrain(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * scale + bias over the batch
    statistics of x [N, C, H, W] (of every rank of ``group``), in fp32,
    cast to x's dtype. Returns (y, mean, var)."""

    @staticmethod
    def forward(ctx, x, scale, bias, group):
        x32 = x.float()
        stats = torch.cat([x32.sum(_DIMS), x32.square().sum(_DIMS)])
        count = x.numel() // x.shape[1]
        if group is not None and group.size > 1:
            stats = ring_collectives.ring_all_reduce(stats, group)
            sync_calls["bn_stats"] += 1
            count *= group.size
        mu, mu2 = (stats / count).chunk(2)
        var = torch.clamp_min(mu2 - mu.square(), 0.0)
        inv = torch.rsqrt(var + BN_EPS)
        y = (x32 - _channel(mu)) * _channel(inv * scale) + _channel(bias)
        ctx.save_for_backward(x, mu, inv, scale)
        ctx.group, ctx.count = group, count
        ctx.mark_non_differentiable(mu, var)
        return y.to(x.dtype), mu, var

    @staticmethod
    def backward(ctx, gy, _g_mean, _g_var):
        x, mu, inv, scale = ctx.saved_tensors
        g32 = gy.float()
        xhat = (x.float() - _channel(mu)) * _channel(inv)
        sums = torch.cat([g32.sum(_DIMS), (g32 * xhat).sum(_DIMS)])
        g_bias, g_scale = sums.chunk(2)
        group = ctx.group
        if group is not None and group.size > 1:
            sums = ring_collectives.ring_all_reduce(sums, group)
            sync_calls["bn_grads"] += 1
        sum_g, sum_gx = (sums / ctx.count).chunk(2)
        dx = (g32 - _channel(sum_g) - xhat * _channel(sum_gx)) * \
            _channel(scale * inv)
        return dx.to(x.dtype), g_scale, g_bias, None


class BatchNorm(nn.Module):
    """flax BatchNorm(momentum=0.9, epsilon=1e-5) over the channels of
    [N, C, H, W]: ``scale``, ``bias`` parameters and ``mean``, ``var``
    buffers (the reference's ``batch_stats``)."""

    def __init__(self, features: int, dtype: torch.dtype,
                 zero_scale: bool = False, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.group = None
        init = torch.zeros if zero_scale else torch.ones
        self.scale = nn.Parameter(init(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.to(self.dtype)
        if not train:
            inv = torch.rsqrt(self.var + BN_EPS)
            y = (x.float() - _channel(self.mean)) * _channel(
                inv * self.scale) + _channel(self.bias)
            return y.to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(x, self.scale, self.bias,
                                             self.group)
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        return y


class Conv(nn.Module):
    """flax Conv without bias: ``weight [out, in, kh, kw]`` (flax's
    [kh, kw, in, out] through models/convert.py), lecun-normal, run in
    ``dtype`` on channels_last activations."""

    def __init__(self, features_in: int, features: int, kernel: int,
                 stride: int, padding: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(
            features, features_in, kernel, kernel, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = self.weight.to(dtype=self.dtype,
                                memory_format=torch.channels_last)
        return F.conv2d(x.to(self.dtype), weight, stride=self.stride,
                        padding=self.padding)


class BottleneckBlock(nn.Module):

    def __init__(self, features_in: int, filters: int, strides: int,
                 dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.conv1 = Conv(features_in, filters, 1, 1, 0, dtype, device)
        self.bn1 = BatchNorm(filters, dtype, device=device)
        self.conv2 = Conv(filters, filters, 3, strides, 1, dtype, device)
        self.bn2 = BatchNorm(filters, dtype, device=device)
        self.conv3 = Conv(filters, filters * 4, 1, 1, 0, dtype, device)
        self.bn3 = BatchNorm(filters * 4, dtype, zero_scale=True,
                             device=device)
        # The reference projects where residual.shape != y.shape.
        self.project = strides != 1 or features_in != filters * 4
        if self.project:
            self.proj_conv = Conv(features_in, filters * 4, 1, strides, 0,
                                  dtype, device)
            self.proj_bn = BatchNorm(filters * 4, dtype, device=device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x
        if self.project:
            residual = self.proj_bn(self.proj_conv(x), train)
        return F.relu(y + residual)


class ResNet(nn.Module):

    def __init__(self, config: ResNetConfig, device=None) -> None:
        super().__init__()
        cfg = self.config = config
        self.stem_conv = Conv(3, cfg.width, 7, 2, 3, cfg.dtype, device)
        self.stem_bn = BatchNorm(cfg.width, cfg.dtype, device=device)
        features = cfg.width
        self.block_names = []
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            for block in range(num_blocks):
                strides = 2 if stage > 0 and block == 0 else 1
                filters = cfg.width * 2 ** stage
                name = f"stage{stage}_block{block}"
                self.add_module(name, BottleneckBlock(
                    features, filters, strides, cfg.dtype, device))
                self.block_names.append(name)
                features = filters * 4
        self.classifier = nn.Linear(features, cfg.num_classes,
                                    device=device)

    def kernel_libraries(self) -> tuple[str, ...]:
        """The kernel libraries a step launches: none (cuDNN's
        convolutions)."""
        return ()

    def batch_norms(self) -> list:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def set_sync_group(self, group) -> None:
        """Sync every batch norm's statistics over ``group`` (a data
        RingGroup, or None for this rank's rows alone)."""
        for bn in self.batch_norms():
            bn.group = group

    def forward(self, images: torch.Tensor, train: bool = True
                ) -> torch.Tensor:
        """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
        x = images.to(self.config.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        pooled = x.mean(dim=(2, 3))
        return self.classifier(pooled.float())


def init_params(model: ResNet, generator: torch.Generator) -> None:
    """flax's initializers in place: convolutions and the classifier
    lecun-normal (fan-in kh * kw * in), the classifier's bias zero; the
    batch norms keep their scale (ones, bn3 zeros), bias and statistics
    as built."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Conv):
                w = module.weight
                lecun_normal_(w, math.prod(w.shape[1:]), generator)
        lecun_normal_(model.classifier.weight,
                      model.classifier.weight.shape[1], generator)
        model.classifier.bias.zero_()


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             device=None) -> ResNet:
    return ResNet(ResNetConfig(num_classes=num_classes, dtype=dtype),
                  device=device)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       denominator: Optional[int] = None) -> torch.Tensor:
    """Mean over the batch of -log softmax(logits)[label], in fp32;
    ``denominator``: divide the sum by it instead (a rank's share of the
    global batch's mean)."""
    logprobs = F.log_softmax(logits.float(), dim=-1)
    picked = logprobs.gather(1, labels.long().view(-1, 1))
    return -picked.sum() / (denominator or logits.shape[0])
