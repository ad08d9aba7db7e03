"""Two pipelines on one card (``pipelines_per_card`` 2): the pair runs
its pipelines in two processes and combines their result lines, at a
small shape on the CPU; a one-pipeline cell starts no process; the
harness refuses any other count.  The two-pipeline cells are built in
memory (or, for the entry point, in a copy of the harness) from the
benchmark's cells."""

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from xbench import pair, spec
from xbench.cell import Readings
from xbench.reference import decode
from xbench.reference.check import Check
from xbench.tests.small import SMALL
from xbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 29
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def paired(workload: str, n=2) -> dict:
    c = spec.cell(workload)
    c["config"] = dict(c["config"], pipelines_per_card=n)
    return c


def run_pair(c, seconds, trace=False, monkeypatch=None):
    """The pair's line, and the parts the parent combined it from."""
    seen = []
    real = pair.combine

    def combine(c, parts, *a, **kw):
        seen.extend(parts)
        return real(c, parts, *a, **kw)

    monkeypatch.setattr(pair, "combine", combine)
    out = pair.run(c, SEED, seconds, trace, device="cpu", override=SMALL,
                   log=lambda s: None)
    return out, seen


def failed(out) -> set:
    return {k for k, v in out["checks"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("workload,trace,seconds", [
    ("xb-products", False, 1.5), ("xb-products", True, 2.0),
    ("fx-ingest", False, 3.0)])
def test_a_pair_runs_two_pipelines_and_combines_them(monkeypatch, workload,
                                                     trace, seconds):
    c = paired(workload)
    out, parts = run_pair(c, seconds, trace, monkeypatch)
    assert len(parts) == 2
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == sum(p["attempted"] for p in parts) >= 4
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["device"]["count"] == 1
    assert set(out["checks"]) == {ch.name for ch in parts[0]["checks"]}
    w = c["workload"]
    if trace:
        host = {m for m in w["per_layer"] if spec.metric(m).SOURCE
                != "device_trace"}
        assert host and host <= set(out["metrics"]) <= set(w["per_layer"])
        assert list(out)[-2] == "breakdown"
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert list(out["metrics"]) == w["end_to_end"]
        assert out["metrics"]["setup_s"]["value"] > 0
    # each pipeline its own channel block and data
    assert [p["readings"].p["pipeline_id"] for p in parts] == [0, 1]


def test_the_pipelines_carry_their_own_channels_and_data():
    c = paired("xb-products")
    runs = [pair.pipeline(c, k, SEED, 1.0, False, "cpu", override=SMALL,
                          log=lambda s: None) for k in range(2)]
    nchan, nsum = SMALL["nchan"], c["config"]["xengine"]["nchan_sum"]
    for k, run in enumerate(runs):
        run.setup()
        h = run.src.header()
        assert (h["pipeline_id"], h["chan0"], h["nchan"]) == (
            k, k * nchan, nchan)
        run.window()
        sent = {name: [pkt for x in s for pkt in x.kept]
                for name, s in run.sends.items()}
        assert all(sent.values())
        assert {decode.part(b)[0]["chan0"] for b in sent["subsel"]} == {
            k * nchan // nsum}
        assert {decode.pbeam(b)[0]["chan0"] for b in sent["pbeam"]} == {
            k * nchan}
        assert {decode.ibeam(b)[0]["chan0"] for b in sent["ibeam"]} == {
            k * nchan}
        checks, _, _ = run.compare()
        assert all(ch.ok for ch in checks)
    a, b = (r.pool for r in runs)
    assert not any(np.array_equal(x, y) for x in a for y in b)
    assert runs[0].commanded["gains"][0].tolist() != \
        runs[1].commanded["gains"][0].tolist()
    assert pair.pipeline_seed(SEED, 0) != pair.pipeline_seed(SEED, 1)


def _altered_in_pipeline_1(conn, plain, k, *args):
    """The worker, with one visibility altered where pipeline 1 encodes
    it (in the worker's own process, so that no other pipeline has the
    fault; there ``pair._worker`` is the harness's)."""
    if k == 1:
        real = pk.encode_corr_part

        def altered(hdr, bl, data):
            data = data.copy()
            data[0, 0, 1] += 1
            return real(hdr, bl, data)

        pk.encode_corr_part = altered
    return pair._worker(conn, plain, k, *args)


def test_an_altered_visibility_in_one_pipeline_is_caught(monkeypatch):
    monkeypatch.setattr(pair, "_worker", _altered_in_pipeline_1)
    out, parts = run_pair(paired("xb-products"), 1.5, False, monkeypatch)
    assert out["correct"] is False
    assert failed(out) == {"subsel_mismatch"}
    assert [all(ch.ok for ch in p["checks"]) for p in parts] == [True, False]


@pytest.mark.parametrize("n", [0, 3, "2", True, 2.0])
def test_another_pipeline_count_is_refused(monkeypatch, n):
    with pytest.raises(ValueError, match="pipelines_per_card"):
        pair.run(paired("xb-products", n), SEED, 1.0, False, device="cpu",
                 override=SMALL)
    real = spec.config
    monkeypatch.setattr(spec, "config", lambda name: dict(
        real(name), pipelines_per_card=n))
    with pytest.raises(ValueError, match="pipelines_per_card"):
        spec.cell("xb-products")


def test_a_one_pipeline_cell_starts_no_process(monkeypatch):
    def refused(self):
        raise AssertionError("a one-pipeline cell started a process")

    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start",
                        refused)
    monkeypatch.setattr(pair, "run_pair", refused)
    out = pair.run(spec.cell("xb-products"), SEED, 1.0, False,
                   device="cpu", override=SMALL, log=lambda s: None)
    assert out["correct"] is True
    assert multiprocessing.active_children() == []


def test_combine_takes_the_card_and_the_worse_pipeline():
    c = spec.cell("fx-ingest")
    s = 10 ** 9
    traces = [Trace([("pfb_fft_kernel", 1 * s, 3 * s),
                     ("Memcpy HtoD", 3 * s, 4 * s)], 0, 10 * s, 5),
              Trace([("pfb_fft_kernel", 2 * s, 5 * s)], 1 * s, 11 * s, 7)]
    spans = [[("compute.put", 5 * s, 9 * s, None)], []]
    parts = [{"readings": Readings(
                 {"acc_len": 2400, "nchan": 192, "nstand": 352, "npol": 2,
                  "pfb_ntap": 4, "adc_dtype": "int8"}, True, 10.0, 0,
                 10 * s, compute_process_s=cps, rtf=rtf, spans=sp,
                 trace=t),
              "peak": peak, "device": {"platform": "gpu", "kind": "H",
                                       "count": 1, "memory_peak_bytes": peak},
              "dumps": [int(d * s) for d in ds],
              "checks": [Check("vis_rel_err", v, 1e-3)],
              "attempted": 2, "failed": int(v > 1e-3), "forbidden": []}
             for t, sp, cps, rtf, peak, v, ds in zip(
                 traces, spans, (8.0, 7.0), (3.0, 2.5), (100, 50),
                 (2e-5, 4e-5), ([0.5, 2, 4, 9.5, 10.5], [1, 6, 10.9]))]
    e2e = pair.combine(c, parts, 12.5, False, log=lambda s: None)
    assert e2e["metrics"]["realtime_factor"]["value"] == 2.5
    assert e2e["metrics"]["device_peak_gib"]["value"] == 150 / 2 ** 30
    assert e2e["metrics"]["setup_s"]["value"] == 12.5
    assert e2e["device"]["memory_peak_bytes"] == 150
    assert e2e["checks"]["vis_rel_err"]["value"] == 4e-5
    assert (e2e["attempted"], e2e["failed"], e2e["correct"]) == (4, 0, True)
    traced = pair.combine(c, parts, 12.5, True, log=lambda s: None)
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    # lower is better: the busier pipeline's 70% (7 s, none blocked)
    # against the other's (8 - 4) / 10
    assert m["compute_busy_share"] == pytest.approx(70.0)
    # the common slice [1, 10) s: kernels 1-3 and 2-5, a copy 3-4
    assert traced["device"]["window_s"] == 9.0
    assert traced["device"]["busy_s"] == 4.0
    assert m["device_idle_share"] == pytest.approx(100 * 5 / 9)
    # the two contexts' kernels cover 1-5 s of the card's time once,
    # over the 3 + 2 windows whose dumps fell in the common slice
    assert m["step_device_ms"] == pytest.approx(1e3 * 4.0 / 5)
    assert traced["breakdown"]["device_ops"][0] == ["pfb_fft_kernel", 4.0]
    gaps = traced["breakdown"]["idle_gaps"]
    assert gaps[0] == ["p0.compute.put", 5.0]
    # a failing value of either pipeline is kept, whatever the order and
    # a NaN among them
    for bad_value in (2e-3, float("nan")):
        for k in (0, 1):
            bad_parts = [dict(p) for p in parts]
            bad_parts[k]["checks"] = [Check("vis_rel_err", bad_value, 1e-3)]
            bad_parts[k]["failed"] = 1
            bad = pair.combine(c, bad_parts, 12.5, False, log=lambda s: None)
            assert (bad["correct"], bad["failed"]) == (False, 1)
            v = bad["checks"]["vis_rel_err"]["value"]
            assert v == bad_value or (np.isnan(v) and np.isnan(bad_value))
    parts[0]["forbidden"] = ["jax"]
    with pytest.raises(RuntimeError, match="jax"):
        pair.combine(c, parts, 12.5, False, log=lambda s: None)


def harness_copy(tmp_path: Path, workload: str, n) -> str:
    """A copy of BENCHMARK.json and the harness with one more cell:
    ``workload`` with its configuration's ``pipelines_per_card`` ``n``
    (files only, as a configuration is added).  Returns its name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "xbench", tmp_path / "xbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    w = spec.workload(workload)
    conf = dict(spec.config(w["config"]), pipelines_per_card=n)
    conf["name"] = f"{conf['name']}-pair"
    name = f"{workload}-pair"
    (tmp_path / "xbench" / "configs" / f"{conf['name']}.json").write_text(
        json.dumps(conf))
    (tmp_path / "xbench" / "workloads" / f"{name}.json").write_text(
        json.dumps(dict(w, config=conf["name"])))
    return name


def _entry(tmp_path, name, seconds):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, "-m", "xbench.run", "--workload",
                           name, "--seed", "97", "--seconds", str(seconds),
                           "--trace", "0"], capture_output=True, text=True,
                          timeout=600, cwd=tmp_path, env=env)


@pytest.mark.parametrize("n", [0, 3, "2"])
def test_the_entry_point_refuses_another_count(tmp_path, n):
    r = _entry(tmp_path, harness_copy(tmp_path, "xb-products", n), 1)
    assert r.returncode == 2 and r.stdout.strip() == ""
    assert "pipelines_per_card" in r.stderr


ON_THE_CARD = """
import json, torch
from xbench import pair, spec
c = spec.cell("xb-products")
c["config"] = dict(c["config"], pipelines_per_card=2)
out = pair.run(c, 77, 5.0, False, log=lambda s: None)
out["parent_cuda_initialized"] = torch.cuda.is_initialized()
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_pair_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", ON_THE_CARD],
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["count"] == 1
    assert out["attempted"] >= 8
    # the workers hold the card; the parent opened no context on it
    assert out["parent_cuda_initialized"] is False
