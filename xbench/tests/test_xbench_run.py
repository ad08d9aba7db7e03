"""A whole run of each cell at a small shape on the CPU (the harness's
look for a card skipped), in a process of its own: the result line's
keys, ``correct``, and no module of JAX or of the JAX package loaded.
Then the entry point's refusals."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from xbench import spec

ROOT = Path(__file__).resolve().parents[2]

DRY = """
import json, sys
from xbench import spec
from xbench.cell import run_cell
from xbench.run import forbidden_modules
from xbench.tests.small import SMALL
out = run_cell(spec.cell(sys.argv[1]), 2 ** 31 + 11, 1.5,
               bool(int(sys.argv[2])), device="cpu", override=SMALL,
               log=lambda s: None)
out["forbidden"] = forbidden_modules()
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["xb-products", "fx-ingest"])
def test_dry_run_on_the_cpu(workload, trace):
    r = subprocess.run([sys.executable, "-c", DRY, workload, str(trace)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 2
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-2] == "checks"
    w = spec.workload(workload)
    if trace:
        # every metric read on the host's side is there on the CPU too
        host = {m for m in w["per_layer"] if spec.metric(m).SOURCE
                in ("program_counter", "program_span", "host_clock")}
        assert host and host <= set(out["metrics"]) <= set(w["per_layer"])
        assert "breakdown" in out
    else:
        assert list(out["metrics"]) == w["end_to_end"]
        assert all(v["value"] > 0 for v in out["metrics"].values()
                   if v["unit"] != "GiB")


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "-m", "xbench.run", "--workload",
                        "xb-products", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=_env())
    if r.returncode == 0:
        pytest.skip("this host has a CUDA device")
    assert r.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory holding only BENCHMARK.json and xbench/ has no program
    to run: no result, a non-zero exit."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "xbench", tmp_path / "xbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-m", "xbench.run", "--workload",
                        "fx-ingest", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path, env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_unknown_cell_is_refused():
    r = subprocess.run([sys.executable, "-m", "xbench.run", "--workload",
                        "../configs/lwa352-xb", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=_env())
    assert r.returncode == 2 and r.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["xb-products", "fx-ingest"])
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "-m", "xbench.run", "--workload",
                        workload, "--seed", "77", "--seconds", "5",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=600, cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
