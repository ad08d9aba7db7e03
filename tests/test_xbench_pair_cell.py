"""The production unit as a benchmark cell: ``xb-pair`` runs
``lwa352-xb-pair``, the ``lwa352-xb`` pipeline as two processes on one
card.  Its files resolve and agree with ``BENCHMARK.json``; each
pipeline's beam streams carry its own ``server`` index (the port's
``PBeamOutput`` and ``IBeamOutput`` take it from ``cfg.pipeline_id``);
pipeline 1 of the pair, served at a small shape on the CPU, compares
``correct`` with its own channel block and server index in every beam
header."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.io import sink
from xbench import pair, spec
from xbench.reference import check, decode
from xbench.tests.small import SMALL

ROOT = Path(__file__).resolve().parents[1]
CELL = "xb-pair"
SEED = 2 ** 31 + 41
PAIR_METRICS = ("served_realtime_factor", "sink_s_per_window",
                "corr_roofline_share")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# -- the cell's files --------------------------------------------------------


def test_the_cell_resolves_to_two_pipelines_on_one_card():
    c = spec.cell(CELL)
    assert spec.pipelines_per_card(c["config"]) == 2
    assert c["workload"]["chips"] == 1
    assert c["config"]["name"] == "lwa352-xb-pair"
    assert c["config"]["reduced"] == []
    # the first pipeline is 0: the harness gives pipeline k pipeline_id k
    assert c["config"]["xengine"]["pipeline_id"] == 0


@pytest.mark.parametrize("key", ["xengine", "engines", "fx", "input",
                                 "sinks", "control"])
def test_the_configuration_is_lwa352_xb_unchanged(key):
    assert spec.config("lwa352-xb-pair")[key] == spec.config("lwa352-xb")[key]


def test_the_guarantees_add_the_server_index():
    pair_g = spec.config("lwa352-xb-pair")["guarantees"]
    one_g = spec.config("lwa352-xb")["guarantees"]
    assert pair_g[:len(one_g)] == one_g
    assert any("server" in g and "chan0" in g for g in pair_g[len(one_g):])


def test_the_cell_gives_a_limit_for_every_number():
    c = spec.cell(CELL)
    nums = check.numbers(c["config"], c["traffic"], c["sinks"])
    assert nums and all(n in c["workload"]["limits"] for n in nums)
    # xb-products' own limits, traffic and metrics
    one = spec.workload("xb-products")
    for key in ("traffic", "end_to_end", "per_layer", "limits"):
        assert c["workload"][key] == one[key], key


def test_benchmark_json_lists_the_cell_and_its_metrics():
    b = bench()
    conf, = [x for x in b["configs"] if x["name"] == "lwa352-xb-pair"]
    assert conf["file"] == "xbench/configs/lwa352-xb-pair.json"
    assert conf["source"] == spec.config("lwa352-xb-pair")["source"]
    cell, = [w for w in b["workloads"] if w["name"] == CELL]
    w = spec.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    assert len(cell["why"]) <= 200
    naming = {m["name"] for m in b["per_layer"]
              if CELL in m.get("workloads", ())}
    assert naming == set(PAIR_METRICS) == set(w["per_layer"])
    rtf, = [m for m in b["end_to_end"] if m["name"] == "realtime_factor"]
    assert CELL not in rtf["workloads"]
    assert "realtime_factor" not in w["end_to_end"]


# -- the beam streams' server index ------------------------------------------


def beam_packets(pcfg, **kw):
    """(PBEAM packets, IBEAM packets) of one window of seeded products
    through the port's sinks built with ``kw``, and the two sinks."""
    rng = np.random.RandomState(7)
    power = rng.randn(pcfg.nbeam // 2, 4, pcfg.nchan, 4).astype(np.float32)
    vlbi = rng.randn(pcfg.ntime_gulp, pcfg.nchan, 2, 2).astype(np.float32)
    pb_pkts: list = []
    ib_pkts: list = []
    pb = sink.PBeamOutput(pcfg, senders={b: pb_pkts.append
                                         for b in range(pcfg.nbeam // 2)},
                          **kw)
    ib = sink.IBeamOutput(pcfg, send=ib_pkts.append, **kw)
    pb.send_powers(power, 960, 24)
    ib.send_voltages(vlbi, 960)
    return (power, vlbi), (pb_pkts, ib_pkts), (pb, ib)


def headers(pb_pkts, ib_pkts):
    return ([decode.pbeam(p)[0] for p in pb_pkts],
            [decode.ibeam(p)[0] for p in ib_pkts])


@pytest.mark.parametrize("case", ["pipeline_1", "pipeline_0_as_jax",
                                  "explicit_wins"])
def test_beam_streams_carry_their_pipelines_server(case):
    jcfg = C.TINY.replace(pipeline_id=0 if case == "pipeline_0_as_jax"
                          else 1, npipeline=4)
    pcfg = TC.XEngineConfig(**dataclasses.asdict(jcfg))
    kw = {"pipeline_idx": 4} if case == "explicit_wins" else {}
    (power, vlbi), (pb_pkts, ib_pkts), sinks = beam_packets(pcfg, **kw)
    assert pb_pkts and ib_pkts
    pbh, ibh = headers(pb_pkts, ib_pkts)
    server = {"pipeline_1": 2, "pipeline_0_as_jax": 1,
              "explicit_wins": 4}[case]
    for h in pbh + ibh:
        assert (h["server"], h["chan0"], h["nserver"]) == (
            server, jcfg.pipeline_id * jcfg.nchan, jcfg.npipeline)
    # the operator's monitor names the server each stream claims
    for s in sinks:
        assert s.pipeline_idx == server
        assert s.counters.publish()["server"] == server
    if case == "pipeline_0_as_jax":
        # pipeline 0 sends the bytes it sent before: the JAX sinks' at
        # their default
        jpb, jib = [], []
        jsink.PBeamOutput(jcfg, senders={b: jpb.append for b in
                                         range(jcfg.nbeam // 2)}) \
            .send_powers(power, 960, 24)
        jsink.IBeamOutput(jcfg, send=jib.append).send_voltages(vlbi, 960)
        assert pb_pkts == jpb and ib_pkts == jib


def test_other_sinks_publish_no_server():
    cfg = TC.XEngineConfig(**dataclasses.asdict(C.TINY))
    for s in (sink.CorrFullOutput(cfg), sink.CorrPartOutput(cfg)):
        assert "server" not in s.counters.publish()


# -- pipeline 1 of the pair, served ------------------------------------------


def test_pipeline_1_of_the_pair_compares_correct():
    """Pipeline 1 of ``xb-pair`` through the served ``XEnginePipeline`` at
    the small shape: the harness's sinks and warm-up (``CellRun.setup``),
    then a fixed number of gulps instead of a wall-clock window, judged by
    ``check.compare``; every beam header carries server 2 and the second
    channel block."""
    c = spec.cell(CELL)
    run = pair.pipeline(c, 1, SEED, 1.0, False, "cpu", override=SMALL,
                        log=lambda s: None)
    run.setup()
    cfg = run.cfg
    assert (cfg.pipeline_id, cfg.chan0) == (1, SMALL["nchan"])
    nwin = 4
    run.pipe.run(nwin * cfg.acc_len // cfg.ntime_gulp, timeout_s=600)
    assert run.pipe.ndump_fast == nwin
    sent = {name: [pkt for x in s for pkt in x.kept]
            for name, s in run.sends.items()}
    assert all(sent.values())
    pbh, ibh = headers(sent["pbeam"], sent["ibeam"])
    for h in pbh + ibh:
        assert (h["server"], h["chan0"]) == (2, SMALL["nchan"])
    checks, attempted, failed = run.compare()
    assert {ch.name for ch in checks} >= set(c["workload"]["limits"])
    assert all(ch.ok for ch in checks), checks
    # both accumulators and at least the first two windows judged
    assert failed == 0 and attempted >= 4
