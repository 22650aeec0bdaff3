"""The platform rules (vitrs_tpu/backend.py), the peak table
(utils/flops.py) and chip_smoke.py's contract, on the CPU."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest

from vitrs_tpu import backend
from vitrs_tpu.config import get_config
from vitrs_tpu.utils import flops as F

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("platform,dtype,head_dim,seq_len,want", [
    ("gpu", jnp.bfloat16, 64, 1024, "cudnn"),      # GPT-2 / MoE cells
    ("gpu", jnp.float16, 64, 1024, "cudnn"),
    ("gpu", jnp.bfloat16, 128, 4096, "cudnn"),     # widest head cuDNN takes
    ("gpu", jnp.bfloat16, 72, 256, "cudnn"),       # head dim a multiple of 8
    ("gpu", jnp.bfloat16, 64, 197, "xla"),         # ViT-B/16: odd T
    ("gpu", jnp.float32, 64, 1024, "xla"),         # fp32: cuDNN needs 16-bit
    ("gpu", jnp.bfloat16, 60, 1024, "xla"),        # not a multiple of 8
    ("gpu", jnp.bfloat16, 256, 1024, "xla"),       # head dim above 128
    ("cpu", jnp.bfloat16, 64, 1024, "xla"),        # the CPU never uses cuDNN
    ("cpu", jnp.float32, 64, 197, "xla"),
])
def test_attention_implementation_rule(platform, dtype, head_dim, seq_len,
                                       want):
    assert backend.attention_implementation(
        platform, dtype, head_dim, seq_len) == want


def test_attention_rule_names_an_implementation():
    """Never None: JAX would fall back from cuDNN to XLA silently."""
    for platform in ("gpu", "cpu"):
        for dtype in (jnp.bfloat16, jnp.float32):
            assert backend.attention_implementation(
                platform, dtype, 64, 1024) in ("cudnn", "xla")


def test_compute_dtype_on_cpu():
    assert not backend.on_accelerator()
    assert backend.compute_dtype() == "float32"


# ---------------------------------------------------------------- peak table

def test_peak_table_h100_row():
    assert F.peak_flops(H100, "bfloat16") == 989e12
    assert F.peak_flops(H100, "float16") == 989e12
    assert F.peak_flops(H100, "float32") == 495e12


@pytest.mark.parametrize("kind", ["AMD Instinct MI300X",
                                  "NVIDIA A100-SXM4-80GB",
                                  "nvidia h100 80gb hbm3"])
def test_peak_table_unknown_accelerator_is_an_error(kind):
    with pytest.raises(KeyError):
        F.peak_flops(kind, "bfloat16")


def test_peak_table_cpu_has_no_peak():
    kind = jax.devices()[0].device_kind
    assert F.peak_flops(kind, "float32") is None
    assert F.mfu(100.0, get_config("gpt-nano"), kind) is None


def test_mfu_against_the_h100_peak():
    cfg = get_config("gpt2-124m", dtype="bfloat16")
    rate = 10.0
    want = rate * F.train_flops_per_example(cfg) / (989e12 * 4)
    assert F.mfu(rate, cfg, H100, n_chips=4) == pytest.approx(want)


# ----------------------------------------------------------- compile cache

def test_compile_cache_env_wins_and_sets_nothing():
    assert backend.compile_cache_dir("/some/cache", True) == (
        "/some/cache", False)
    assert backend.compile_cache_dir("/some/cache", False) == (
        "/some/cache", False)


def test_compile_cache_fixed_path_in_checkout_on_accelerator():
    path, must_set = backend.compile_cache_dir(None, True)
    assert must_set and path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_off_on_cpu(monkeypatch):
    assert backend.compile_cache_dir(None, False) == (None, False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert backend.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


# ---------------------------------------------------------------- chip_smoke

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Dev:
    platform, device_kind = "gpu", H100


@pytest.mark.parametrize("count", [1, 4])
def test_chip_smoke_last_line(count):
    line = _chip_smoke().result_line([_Dev()] * count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": H100, "count": count}}
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"{H100}", "count": {count}}}}}')


def test_chip_smoke_fails_without_a_gpu(capsys):
    assert _chip_smoke().main() == 1
    out = capsys.readouterr().out
    assert "FAILED" in out and '"ok"' not in out
