"""Model-FLOPs utilization for the port's training path.

The port's own copy of batch_shipyard_tpu/parallel/mfu.py's ResNet-50
and transformer accounting (the port imports nothing of the JAX package):

- one multiply-accumulate = 2 FLOPs; a training step = 3x forward;
- ResNet-50: torchvision's 4.09 GMACs a forward image at 224x224,
  scaled with the image's area;
- PaLM-appendix FLOPs per trained token: 6*N for the parameter matmuls
  (N includes the tied embedding, whose output projection is a
  per-token matmul) plus the attention term 12*L*T*d_model, halved for
  causal masking.

The peak comes from a table keyed on ``torch.cuda.get_device_name()``:
the published dense bf16 rate of that card, or None for a card not in
the table (an absent MFU is honest; a guessed denominator is not).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

# Dense bf16 tensor-core peaks, TFLOP/s (NVIDIA data sheets, SXM parts,
# without sparsity), keyed on the CUDA device name.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.0,
}


def peak_bf16_tflops(device_name: Optional[str] = None) -> Optional[float]:
    """The card's dense bf16 peak, or None when the name is not in the
    table (or no CUDA device is present and no name is given)."""
    if device_name is None:
        if not torch.cuda.is_available():
            return None
        device_name = torch.cuda.get_device_name(0)
    return PEAK_BF16_TFLOPS.get(device_name)


# torchvision-standard ResNet-50 forward cost at 224x224: 4.09 GMACs.
_RESNET50_FWD_MACS_224 = 4.09e9


def resnet50_train_flops_per_image(image_size: int = 224) -> float:
    """Analytic ResNet-50 training FLOPs per image. Conv cost scales with
    spatial area, so other sizes scale quadratically (exact for all but
    the fixed-cost final FC, < 0.1%)."""
    fwd = 2.0 * _RESNET50_FWD_MACS_224 * (image_size / 224.0) ** 2
    return 3.0 * fwd


def transformer_param_count(config: Any) -> int:
    """Parameters of models/transformer.TransformerLM from its config:
    embedding, per block q/k/v/o and SwiGLU gate/up/down plus two
    RMSNorm scales, and the final norm (the output projection is the
    tied embedding)."""
    d, v = config.d_model, config.vocab_size
    h, dh, ff = config.n_heads, config.d_head, config.d_ff
    per_block = (
        3 * d * h * dh        # q, k, v projections
        + h * dh * d          # output projection
        + 3 * d * ff          # SwiGLU gate, up, down
        + 2 * d               # two RMSNorm scales
    )
    return v * d + config.n_layers * per_block + d  # + final norm


def transformer_train_flops_per_token(config: Any, seq_len: int,
                                      causal: bool = True) -> float:
    """6*N for the parameter matmuls (forward 2N, backward 4N) plus
    attention 12*L*T*d (6*L*T*d causal)."""
    n = transformer_param_count(config)
    attn = 12.0 * config.n_layers * seq_len * config.d_model
    if causal:
        attn *= 0.5
    return 6.0 * n + attn


def mfu_pct(items_per_sec_per_chip: float, flops_per_item: float,
            peak_tflops_per_chip: Optional[float]) -> Optional[float]:
    """Achieved model FLOPs as a percentage of one card's bf16 peak;
    None when the peak is unknown."""
    if peak_tflops_per_chip is None or peak_tflops_per_chip <= 0:
        return None
    achieved = items_per_sec_per_chip * flops_per_item
    return 100.0 * achieved / (peak_tflops_per_chip * 1e12)
