"""Tests that need an NVIDIA card (marker `gpu`).

The test process itself stays on the CPU (conftest.py); the card is used by
one child process at a time, since a JAX process reserves most of the card's
memory.  Without a card these skip.  On a machine with one:

    python -m pytest tests/ -m gpu
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _gpu_env():
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA card: nvidia-smi is not on PATH")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.gpu
def test_chip_smoke_on_the_card():
    """chip_smoke.py's every phase on one card: kernel parity at the models'
    widths, training through the entry points, generation."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_gpu_env(), capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
