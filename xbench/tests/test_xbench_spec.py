"""Every piece of the benchmark loads by name, and BENCHMARK.json agrees
with the files under ``xbench/``."""

import json
import re
from pathlib import Path

import numpy as np
import pytest

from xbench import sinks, spec
from xbench.cell import Readings
from xbench.cell import keep_set
from xbench.traffic.pool import PoolSource, make_pool

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("kind", ["workloads", "configs", "traffic",
                                  "sinks", "metrics"])
def test_every_file_loads_by_name(kind):
    names = spec.names(kind)
    assert names
    for n in names:
        if kind == "sinks":
            m = sinks.kind(n)
            assert m.ATTR and m.METHOD and m.NUMBERS
            assert isinstance(m.SEQ_ARG, int)
            assert all(callable(getattr(m, f)) for f in (
                "commands", "build", "decode_packet", "judge"))
        elif kind == "metrics":
            m = spec.metric(n)
            assert m.UNIT and m.LAYER and m.MOVES and m.SOURCE
            assert callable(m.read)
        else:
            assert isinstance(getattr(spec, {"workloads": "workload",
                                             "configs": "config",
                                             "traffic": "traffic"}[kind])(n),
                              dict)


@pytest.mark.parametrize("name", spec.names("workloads"))
def test_cell_resolves(name):
    c = spec.cell(name)
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert len(c["workload"]["why"]) <= 200


def test_bad_names_are_refused():
    for bad in ("../configs/lwa352-xb", "a/b", "", "x" * 65):
        with pytest.raises(ValueError):
            spec.workload(bad)
    with pytest.raises(FileNotFoundError):
        spec.workload("no-such-cell")


def test_benchmark_json_matches_the_files():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["xbench"]
    for c in b["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
    layers = {}
    for w in b["workloads"]:
        f = spec.workload(w["name"])
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        for m in f["per_layer"]:
            layers.setdefault(m, set()).add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == set(spec.END_TO_END)
    cells = {w["name"] for w in b["workloads"]}
    reports = {w: set(spec.workload(w)["end_to_end"]) for w in cells}
    for m in b["end_to_end"]:
        # a metric with no workloads key is reported in every cell
        assert set(m.get("workloads", cells)) == {
            w for w in cells if m["name"] in reports[w]}
    for m in b["per_layer"]:
        mod = spec.metric(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"])
        assert set(m["workloads"]) == layers[m["name"]]
        # the end-to-end metric it moves is reported in each of its cells
        assert all(m["moves"] in reports[w] for w in m["workloads"])
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_pool_reproduces_from_the_seed():
    seed = 2 ** 31 + 12345
    a = make_pool(3, (6, 4, 8), "packed", seed, "cpu")
    b = make_pool(3, (6, 4, 8), "packed", seed, "cpu")
    c = make_pool(3, (6, 4, 8), "packed", seed + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
    adc = make_pool(2, (64, 8), "adc_int8", seed, "cpu", amplitude=32.0)
    assert adc[0].dtype == np.int8 and 20 < adc[0].std() < 45
    assert np.array_equal(adc[1], make_pool(2, (64, 8), "adc_int8", seed,
                                            "cpu", amplitude=32.0)[1])


def test_a_sink_without_a_module_or_a_number_without_a_limit_is_refused(
        monkeypatch):
    real_traffic, real_workload = spec.traffic, spec.workload
    monkeypatch.setattr(spec, "traffic", lambda n: dict(
        real_traffic(n), sinks=["subsel", "cor"]))
    with pytest.raises(ValueError, match="no module"):
        spec.cell("xb-products")
    monkeypatch.setattr(spec, "traffic", real_traffic)
    w = real_workload("xb-products")
    w["limits"] = {k: v for k, v in w["limits"].items() if k != "vlbi_err"}
    monkeypatch.setattr(spec, "workload", lambda n: w)
    with pytest.raises(ValueError, match="vlbi_err"):
        spec.cell("xb-products")


@pytest.mark.parametrize("e2e", [["device_peak_gib"],
                                 ["setup_s", "ttft_p95_ms"]])
def test_a_cell_without_setup_s_or_with_an_unknown_metric_is_refused(
        monkeypatch, e2e):
    w = dict(spec.workload("fx-ingest"), end_to_end=e2e)
    monkeypatch.setattr(spec, "workload", lambda n: w)
    with pytest.raises(ValueError, match="end-to-end"):
        spec.cell("fx-ingest")


def test_served_realtime_factor_reads_the_run_rate():
    m = spec.metric("served_realtime_factor")
    r = Readings({}, False, 30.0, 0, 1, rtf=0.375)
    assert m.read(r) == 0.375


def test_every_cell_gives_a_limit_for_each_number():
    from xbench.reference import check

    for name in spec.names("workloads"):
        c = spec.cell(name)
        want = set(check.numbers(c["config"], c["traffic"], c["sinks"]))
        assert want == set(c["workload"]["limits"])


def test_the_source_refuses_a_second_write():
    from caltech_bifrost_dsp_tpu_torch.config import TINY

    pool = make_pool(2, (TINY.ntime_gulp, TINY.nchan, TINY.ninput),
                     "packed", 5, "cpu")
    src = PoolSource(TINY, pool)
    slots = [np.empty(pool[0].nbytes, np.uint8) for _ in range(3)]
    for i in range(3):          # a ring of 3 slots for a pool of 2
        src.fill_into(slots[i])
    with pytest.raises(RuntimeError, match="wrote 3 gulps"):
        src.check_written_once()
    ok = PoolSource(TINY, pool)
    for i in range(6):
        ok.fill_into(slots[i % 2])
    ok.check_written_once()
    assert ok.nwritten == 2


def test_compute_busy_share_leaves_out_the_blocked_put():
    m = spec.metric("compute_busy_share")
    s = 10 ** 9
    spans = [("compute.put", 1 * s, 3 * s, None),      # in the window
             ("compute.step", 3 * s, 4 * s, None),
             ("compute.put", -2 * s, -1 * s, None),    # before it
             ("compute.put", 9 * s, 11 * s, None)]     # ends after it
    r = Readings({}, False, 10.0, 0, 10 * s, compute_process_s=6.0,
                 spans=spans)
    assert m.read(r) == pytest.approx(40.0)
    r.compute_process_s = None
    assert m.read(r) is None


def test_pool_source_cycles_and_stops():
    from caltech_bifrost_dsp_tpu_torch.config import TINY

    pool = make_pool(3, (TINY.ntime_gulp, TINY.nchan, TINY.ninput),
                     "packed", 5, "cpu")
    src = PoolSource(TINY, pool)
    dest = np.empty(pool[0].nbytes, np.uint8)
    for i in range(5):
        assert src.fill_into(dest) == i * TINY.ntime_gulp
        assert np.array_equal(dest.reshape(pool[0].shape), pool[i % 3])
    assert src.header(seq0=96)["seq0"] == 96
    src.stop()
    assert src.fill_into(dest) is None
    # a reservation that already holds its gulp is not written again
    one = PoolSource(TINY, pool[:1])
    one.fill_into(dest)
    dest[:] = 0
    one.fill_into(dest)
    assert (one.nfilled, one.nwritten) == (2, 1) and not dest.any()


def test_keep_set_is_seeded():
    t = spec.traffic("products")
    a, b = keep_set(t, 7), keep_set(t, 7)
    assert a == b and {0, 1} <= a
    assert len(a) == t["keep"]["max_windows"]
    assert keep_set(t, 8) != a
    assert keep_set(spec.traffic("ingest"), 7) == set()
