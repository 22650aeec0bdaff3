"""vitrs_tpu — a JAX Vision Transformer / GPT framework.

A ground-up JAX/XLA rebuild with the capabilities of Simon-Kotchou/ViT.rs
(the llm.c-inspired Rust transformer), run on NVIDIA GPUs: bf16 matmuls on
the tensor cores, cuDNN fused attention, shard_map data / tensor / pipeline /
expert parallelism, and a host-side native data pipeline.  The package name
is an identifier, not a statement about the hardware.
"""

from .config import ViTConfig, get_config, PRESETS
from .vit import ViT
from . import params
from . import checkpoint

__version__ = "0.1.0"
