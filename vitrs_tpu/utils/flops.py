"""Model FLOPs accounting for MFU reporting (SURVEY.md §5.1: per-step
wall-clock + MFU, forward 2PD + backward 4PD per token plus explicit
attention terms)."""

from __future__ import annotations

from typing import Optional

from ..config import ViTConfig

# Per-card peak dense matmul throughput, FLOP/s, keyed by the exact
# `jax.Device.device_kind`.  Source: NVIDIA H100 SXM data sheet, dense rates
# without sparsity, at the 700 W limit: 989 TFLOP/s bf16/fp16 and 495
# TFLOP/s TF32 (what XLA runs fp32 matmuls in at default precision).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                              "float32": 495e12},
}


def peak_flops(device_kind: str, dtype: str) -> Optional[float]:
    """Peak FLOP/s of one card.  None on the CPU, which has no peak in this
    table (MFU is not reported there); an accelerator missing from the
    table is an error, never a default."""
    if device_kind.lower() == "cpu":
        return None
    if device_kind not in PEAK_FLOPS:
        raise KeyError(f"no peak FLOP/s for device kind {device_kind!r}; "
                       f"add it to utils/flops.PEAK_FLOPS with its source")
    return PEAK_FLOPS[device_kind][dtype]


def forward_flops_per_example(cfg: ViTConfig) -> float:
    """Matmul FLOPs for one example's forward pass (2·MACs)."""
    C, L = cfg.channels, cfg.num_layers
    T = cfg.seq_len
    # qkv (C+2*kv_dim wide under GQA; 3C for MHA), proj, fc, fcproj.
    # MoE: each token runs top_k expert MLPs plus the (C, E) router —
    # the standard sparse-MFU convention counts only EXECUTED FLOPs
    # (dropped assignments still occupy their dispatch slot, so this is
    # the ceiling of useful work, matching Switch/GShard reporting)
    mlp_mult = cfg.moe_top_k if cfg.is_moe else 1
    router = 2 * C * cfg.num_experts if cfg.is_moe else 0
    per_tok_layer = 2 * (cfg.qkv_dim * C + C * C
                         + mlp_mult * (4 * C * C + 4 * C * C)) + router
    # QK^T + PV: 2 matmuls x 2 flops.  Convention: the full T x T square is
    # counted for causal (the standard MFU convention — llm.c/PaLM count
    # unmasked FLOPs); the windowed analogue is the full T x window band, so
    # windowed MFU stays comparable to the causal numbers.
    attn_width = min(cfg.window, T) if (cfg.mode == "gpt" and cfg.window) \
        else T
    attn_layer = 4 * T * attn_width * C
    if cfg.mode == "vit":
        embed = 2 * T * (cfg.patch_size ** 2 * cfg.in_chans) * C
        head = 2 * C * cfg.num_classes
    else:
        embed = 0                          # table lookup
        head = 2 * T * C * cfg.vocab_size  # tied vocab projection
    return T * per_tok_layer * L + attn_layer * L + embed + head


def train_flops_per_example(cfg: ViTConfig) -> float:
    """fwd + bwd ≈ 3x forward (backward re-does each matmul twice)."""
    return 3.0 * forward_flops_per_example(cfg)


def mfu(examples_per_sec: float, cfg: ViTConfig, device_kind: str,
        n_chips: int = 1, train: bool = True) -> Optional[float]:
    """Model FLOP/s utilization; None where the device has no peak (CPU)."""
    peak = peak_flops(device_kind, cfg.dtype)
    if peak is None:
        return None
    f = train_flops_per_example(cfg) if train else forward_flops_per_example(cfg)
    return examples_per_sec * f / (peak * n_chips)
