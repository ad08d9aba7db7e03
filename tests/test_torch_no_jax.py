"""The port, its CLI, the FX bench and ``chip_smoke.py`` import without
JAX, and the CLI and the bench refuse to run on a host without a card."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

IMPORT_ALL = """
import sys
import caltech_bifrost_dsp_tpu_torch.io.source
import caltech_bifrost_dsp_tpu_torch.models.xengine
import caltech_bifrost_dsp_tpu_torch.ops.pfb
import caltech_bifrost_dsp_tpu_torch.ops.pfb_fused
import caltech_bifrost_dsp_tpu_torch.runtime.runner
import caltech_bifrost_dsp_tpu_torch.scripts.bench_fx
import caltech_bifrost_dsp_tpu_torch.scripts.pipeline
import chip_smoke
from caltech_bifrost_dsp_tpu.config import TINY
from caltech_bifrost_dsp_tpu_torch.runtime.runner import XEngineRunner
XEngineRunner(TINY.replace(adc_dtype="int8"), "cpu", fx=True)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib")
assert not bad, bad
print("no jax")
"""


def _run(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    proc = _run(["-c", IMPORT_ALL])
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


def test_cli_device_cuda_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["-m", "caltech_bifrost_dsp_tpu_torch.scripts.pipeline",
                 "--fakesource", "--ngulp", "1", "--device", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_bench_fx_fails_loudly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(["-m", "caltech_bifrost_dsp_tpu_torch.scripts.bench_fx",
                 "--fengine", "--nspec", "1"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
