"""The port, its CLI, the FX bench and ``chip_smoke.py`` import without
JAX and without any module of the JAX package, an ``XEnginePipeline`` runs
on the CPU (unsharded and on a 2x2 mesh) in such a process, and
the CLI and the bench refuse to run on a host without a card."""

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
import caltech_bifrost_dsp_tpu_torch.config
import caltech_bifrost_dsp_tpu_torch.control.command
import caltech_bifrost_dsp_tpu_torch.control.monitor
import caltech_bifrost_dsp_tpu_torch.control.store
import caltech_bifrost_dsp_tpu_torch.io.packets
import caltech_bifrost_dsp_tpu_torch.io.sink
import caltech_bifrost_dsp_tpu_torch.io.source
import caltech_bifrost_dsp_tpu_torch.models.xengine
import caltech_bifrost_dsp_tpu_torch.ops.corr_blk
import caltech_bifrost_dsp_tpu_torch.ops.corr_rows
import caltech_bifrost_dsp_tpu_torch.ops.corr_triu
import caltech_bifrost_dsp_tpu_torch.ops.pfb
import caltech_bifrost_dsp_tpu_torch.ops.pfb_fused
import caltech_bifrost_dsp_tpu_torch.parallel.mesh
import caltech_bifrost_dsp_tpu_torch.runtime.arming
import caltech_bifrost_dsp_tpu_torch.runtime.driver
import caltech_bifrost_dsp_tpu_torch.runtime.ring
import caltech_bifrost_dsp_tpu_torch.runtime.runner
import caltech_bifrost_dsp_tpu_torch.scripts.bench_fx
import caltech_bifrost_dsp_tpu_torch.scripts.pipeline
import caltech_bifrost_dsp_tpu_torch.utils.proclog
import chip_smoke
from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io.sink import CorrPartOutput
from caltech_bifrost_dsp_tpu_torch.io.source import SyntheticSource
from caltech_bifrost_dsp_tpu_torch.parallel.mesh import make_mesh
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.runtime.runner import XEngineRunner
XEngineRunner(TINY.replace(adc_dtype="int8"), "cpu", fx=True)
cfg = TINY.replace(corr_engine="pallas_triu", subsel_engine="pallas")
pkts = []
pipe = XEnginePipeline(cfg, SyntheticSource(cfg, mode="random"),
                       subsel_outputs=[CorrPartOutput(cfg, send=pkts.append)],
                       device="cpu")
pipe.run(20, timeout_s=60)
assert pipe.ndump_fast == 4 and pipe.ndump_slow == 2 and pkts
mpkts = []
mpipe = XEnginePipeline(cfg, SyntheticSource(cfg, mode="random"),
                        subsel_outputs=[CorrPartOutput(cfg,
                                                       send=mpkts.append)],
                        device="cpu",
                        mesh=make_mesh(2, 2, devices=["cpu"] * 4))
mpipe.run(20, timeout_s=60)
assert mpkts == pkts
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "jaxlib")
assert not bad, bad
ref = sorted(m for m in sys.modules if m == "caltech_bifrost_dsp_tpu"
             or m.startswith("caltech_bifrost_dsp_tpu."))
assert not ref, ref
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
