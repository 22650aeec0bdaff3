"""The one place the program asks what it runs on.

The CPU runs the tests and small drives; a GPU runs training and serving.
Everything that differs between the two is decided here, by stated rules:

* `on_accelerator` — whether JAX's default backend is an accelerator;
* `compute_dtype` — the activation dtype of an entry point given none;
* `attention_implementation` — which form of `jax.nn.dot_product_attention`
  the attention op (ops/attention.py) calls;
* `enable_compile_cache` — the persistent compile cache every entry point
  turns on.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILE_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

# cuDNN's fused attention takes 16-bit inputs with a head dim that is a
# multiple of 8 (jax/_src/cudnn/fused_attention_stablehlo.py,
# check_is_flash_attention); 128 is within every card's bound
CUDNN_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))
CUDNN_MAX_HEAD_DIM = 128


def on_accelerator() -> bool:
    return jax.default_backend() != "cpu"


def compute_dtype() -> str:
    """bf16 on the accelerator (the tensor cores' rate), fp32 on the CPU."""
    return "bfloat16" if on_accelerator() else "float32"


def attention_implementation(platform: str, dtype, head_dim: int,
                             seq_len: int) -> str:
    """The rule for `jax.nn.dot_product_attention(implementation=...)`:

    * "cudnn" — cuDNN's fused flash attention, which never writes the
      (B, H, T, T) scores to memory — on a GPU, for bf16/fp16 inputs whose
      head dim is a multiple of 8 and at most 128, at an even sequence
      length (cuDNN's backward refuses odd ones: measured at ViT-B/16's
      T=197 on an H100, PERF.md);
    * "xla" — XLA's softmax(QKᵀ)V, which materializes the scores —
      everywhere else: fp32 inputs, odd sequence lengths, and every shape
      on the CPU.

    Both are named explicitly: `implementation=None` would let JAX fall
    back from cuDNN to XLA without a word."""
    if (platform == "gpu" and jnp.dtype(dtype) in CUDNN_DTYPES
            and head_dim % 8 == 0 and head_dim <= CUDNN_MAX_HEAD_DIM
            and seq_len % 2 == 0):
        return "cudnn"
    return "xla"


def compile_cache_dir(env_dir: Optional[str], accelerator: bool
                      ) -> Tuple[Optional[str], bool]:
    """The rule for the persistent compile cache: (directory, whether this
    program must set it).

    * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself; nothing is set.
    * otherwise, on an accelerator: `.jax_cache/` in the checkout
      (git-ignored), so that a rerun finds what the last run compiled.
    * otherwise, on the CPU: no cache — XLA:CPU's loader can reject or
      crash on entries whose machine features differ (tests/conftest.py)."""
    if env_dir:
        return env_dir, False
    if accelerator:
        return COMPILE_CACHE_DIR, True
    return None, False


def enable_compile_cache() -> Optional[str]:
    """Turn on JAX's persistent compile cache by `compile_cache_dir`'s rule;
    returns its directory (None: no cache).  Every entry point calls this."""
    path, must_set = compile_cache_dir(
        os.environ.get("JAX_COMPILATION_CACHE_DIR"), on_accelerator())
    if must_set:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_description() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W": a card set below its full power
    limit runs slower under load, so every timing is reported beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]
