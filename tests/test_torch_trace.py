"""The port's span recorder and counters (``utils/proclog.py``), in the
served driver and the sinks, on the CPU: nothing recorded with spans off;
with them on, every span of the driver's threads once per window or gulp,
children inside their parents, stamps on ``time.time_ns()``'s clock; the
sinks' counters against what they sent and slept; the compute thread's
process laps still holding the blocked hand-off."""

import gc
import time

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.monitor import (MonitorBridge,
                                                           render_text)
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io.source import SyntheticSource
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)

CFG = TC.TINY
GPW = CFG.acc_len // CFG.ntime_gulp
NWIN = 4
#: spans of the compute and output threads, one per fast window
PER_WINDOW = ("compute.process", "compute.upload", "compute.launch",
              "compute.emit.put", "output.get", "output.fetch",
              "output.subsel", "output.pbeam", "output.ibeam")
#: spans of the ingest thread and the compute thread's waits, one a gulp
PER_GULP = ("ingest.reserve", "ingest.fill", "ingest.commit",
            "compute.acquire", "compute.reserve")


@pytest.fixture(autouse=True)
def _fresh():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield
    proclog.enable_spans(False)


class Sent:
    """The packets of each sink of one pipeline."""

    def __init__(self):
        self.cor, self.sub, self.pb, self.ib = [], [], [], []


def sinks(got: Sent, sub_send=None):
    return dict(
        corr_outputs=[sink.CorrFullOutput(CFG, send=got.cor.append,
                                          use_cor_fmt=True)],
        subsel_outputs=[sink.CorrPartOutput(
            CFG, send=sub_send or got.sub.append)],
        pbeam_outputs=[sink.PBeamOutput(
            CFG, senders={b: got.pb.append for b in range(CFG.nbeam // 2)})],
        ibeam_outputs=[sink.IBeamOutput(CFG, send=got.ib.append)])


def run(spans: bool, nwin: int = NWIN, sub_send=None):
    """A pipeline of every sink over ``nwin`` windows of random bytes;
    returns (pipeline, packets, spans recorded while it ran, t0, t1)."""
    got = Sent()
    pipe = XEnginePipeline(CFG, SyntheticSource(CFG, mode="random"),
                           store=MemoryStore(), device="cpu",
                           **sinks(got, sub_send))
    proclog.enable_spans(spans)
    t0 = time.time_ns()
    pipe.run(nwin * GPW, timeout_s=300)
    t1 = time.time_ns()
    proclog.enable_spans(False)
    return pipe, got, proclog.spans_between(t0, t1), t0, t1


def test_spans_off_record_nothing():
    pipe, got, recs, _, _ = run(spans=False)
    assert pipe.ndump_fast == NWIN and got.ib
    assert recs == []
    assert pipe.perf_compute._open is None
    assert proclog.span("x") is proclog.span("y")
    assert not proclog.span("x")


def test_spans_on_each_window_once():
    pipe, got, recs, t0, t1 = run(spans=True)
    assert pipe.ndump_fast == NWIN
    by = {}
    for r in recs:
        by.setdefault(r[0], []).append(r)
    for name in PER_WINDOW:
        ws = sorted(r[3] for r in by[name] if r[3] is not None)
        assert ws == list(range(NWIN)), name
    # the last get receives the end of the stream, no window
    assert [r[3] for r in by["output.get"]].count(None) == 1
    for name in PER_GULP:
        ws = sorted(r[3] for r in by[name])
        assert ws == sorted(list(range(NWIN)) * GPW), name
    # one slow dump every two windows, from windows 0 and 2
    assert sorted(r[3] for r in by["output.cor"]) == [0, 2]
    # no card: no pinned copy, no wait for an H2D
    assert "compute.upload.copy" not in by
    assert "compute.upload.h2d_wait" not in by
    # stamps on time.time_ns()'s clock, each span inside its parent
    for name, a, b, w, parent in recs:
        assert t0 <= a <= b <= t1, name
        if parent is None:
            continue
        assert any(p[1] <= a and b <= p[2] and p[3] == w
                   for p in by[parent]), (name, parent, w)
    # plain tuples, which a collection stops tracking: a full recorder
    # adds nothing to the interpreter's full collections
    gc.collect()
    assert not any(gc.is_tracked(r) for r in recs)
    assert {r[4] for r in by["compute.upload"]} == {"compute.process"}
    assert {r[4] for r in by["compute.emit.put"]} == {"compute.process"}
    # with spans on, the sinks' seconds split into encode, send, throttle
    ib = pipe.ibeam_outputs[0].counters
    assert ib.encode_s > 0 and ib.send_s > 0
    assert ib.encode_s + ib.send_s + ib.throttle_s == pytest.approx(
        ib.process_time, rel=1e-6)
    # the process spans are the laps perf_compute counts
    proc = sum(r[2] - r[1] for r in by["compute.process"]) / 1e9
    assert proc == pytest.approx(pipe.perf_compute.process_time, rel=0.05,
                                 abs=2e-3)


@pytest.mark.parametrize("spans", [False, True])
def test_slow_fetch_span_and_counters(spans):
    """Each slow dump's planes come back inside one ``output.fetch.slow``
    span, a child of its window's ``output.fetch``; the ``Corr`` stats
    count the slow dumps put on the products queue, spans on or off."""
    pipe, got, recs, _, _ = run(spans=spans)
    slow = [r for r in recs if r[0] == "output.fetch.slow"]
    if spans:
        # a slow dump every two windows, emitted with windows 1 and 3
        assert sorted(r[3] for r in slow) == [1, 3]
        assert {r[4] for r in slow} == {"output.fetch"}
    else:
        assert slow == []
    # two dumps of NWIN windows, each sent by the COR sink
    assert pipe.corr_cmd.stats["slow_dumps"] == len(got.cor) // (
        CFG.nstand * (CFG.nstand + 1) // 2) == 2


def test_sink_counters_are_what_the_sinks_sent():
    pipe, got, _, _, _ = run(spans=False)
    sent = {"cor": got.cor, "subsel": got.sub, "pbeam": got.pb,
            "ibeam": got.ib}
    for oc in pipe.output_cmds:
        c = oc.sink.counters
        pkts = sent[c.span_name.split(".")[1]]
        assert pkts and c.npkt == len(pkts)
        assert c.nbyte == sum(len(p) for p in pkts)
        # published through the sink's command block
        rec = oc.perf_proclog.snapshot()
        assert rec["npkt"] == c.npkt and rec["process_time"] > 0
        assert rec["gbps"] > 0 and rec["encode_s"] == rec["send_s"] == 0
    # the operator's dashboard shows each sink's process time and rate
    st = MemoryStore()
    MonitorBridge(st, host="h").publish_once()
    rows = {ln.split()[0]: ln for ln in render_text(st).splitlines()}
    for name in ("CorrOutputFull", "CorrOutputPart", "BeamformOutput",
                 "BeamformVlbiOutput"):
        assert "proc=0.000 " not in rows[name] and "gbps=0.00 " not in \
            rows[name], rows[name]


@pytest.mark.parametrize("case", ["cor", "custom", "part", "part_cor",
                                  "pbeam", "ibeam"])
def test_sink_counters_equal_each_call(case):
    rng = np.random.default_rng(5)
    pkts = []
    n = CFG.nchan * CFG.ninput * CFG.ninput
    if case in ("cor", "custom"):
        s = sink.CorrFullOutput(CFG, send=pkts.append,
                                use_cor_fmt=case == "cor")
        planes = [rng.integers(-99, 99, n, np.int32).reshape(
            CFG.nchan, CFG.ninput, CFG.ninput) for _ in range(2)]
        ret = s.send_matrix_planes(*planes, 0, 480, 480)
    elif case.startswith("part"):
        s = sink.CorrPartOutput(CFG, send=pkts.append,
                                use_cor_fmt=case == "part_cor")
        shape = (CFG.nchan // CFG.nchan_sum, CFG.nvis_out)
        sub = [rng.integers(-9, 9, shape, np.int32) for _ in range(2)]
        bl = np.zeros((CFG.nvis_out, 2, 2), np.uint32)
        ret = s.send_subsel(*sub, bl, 0, 240, 240)
    elif case == "pbeam":
        s = sink.PBeamOutput(CFG, senders={0: pkts.append, 1: pkts.append})
        ret = s.send_powers(rng.random((2, 10, CFG.nchan, 4), np.float32),
                            240, 24)
    else:
        s = sink.IBeamOutput(CFG, send=pkts.append)
        ret = s.send_voltages(rng.random((240, CFG.nchan, 2, 2),
                                         np.float32), 240)
    assert ret == s.counters.npkt == len(pkts) > 0
    assert s.counters.nbyte == sum(len(p) for p in pkts)


def test_throttle_counts_its_sleeps(monkeypatch):
    """Under a patched clock the IBEAM sink's ``throttle_s`` is the sum of
    its throttle's sleeps, each one an ``output.ibeam.throttle`` span."""
    now = [100.0]
    slept = []

    def sleep(dt):
        slept.append(dt)
        now[0] += dt

    monkeypatch.setattr(sink.time, "monotonic", lambda: now[0])
    monkeypatch.setattr(sink.time, "sleep", sleep)
    s = sink.IBeamOutput(CFG, send=lambda p: None)
    th = s.throttle
    got = [th.account(8 * 1500) for _ in range(40)]
    assert got.count(0.0) == 39 and slept[0] > 0
    assert got[31] == pytest.approx(slept[0], rel=1e-9)
    proclog.enable_spans(True)
    t0 = time.time_ns()
    s.send_voltages(np.ones((1200, CFG.nchan, 2, 2), np.float32), 480)
    proclog.enable_spans(False)
    assert len(slept) > 2
    assert s.counters.throttle_s == pytest.approx(sum(slept[1:]),
                                                  rel=1e-9)
    recs = proclog.spans_between(t0, time.time_ns())
    thr = [r for r in recs if r[0] == "output.ibeam.throttle"]
    assert len(thr) == len(slept) - 1
    assert {(r[3], r[4]) for r in thr} == {(2, "output.ibeam")}
    assert s.counters.send_s > 0


def test_process_time_still_holds_the_put():
    """A slow output thread fills the products queue: the compute thread's
    process laps hold its blocked puts (``compute_busy_share`` subtracts
    them)."""
    def slow(pkt):
        time.sleep(5e-4)   # 294 packets: ~0.15 s a window

    pipe, _, recs, _, _ = run(spans=True, nwin=12, sub_send=slow)
    puts = sum(b - a for n, a, b, *_ in recs if n == "compute.emit.put")
    assert puts / 1e9 > 0.2
    assert pipe.perf_compute.process_time >= puts / 1e9
    stats = pipe.corr_cmd.stats
    assert stats["out_queue_nfull"] >= 1
    assert 0 < stats["staging_held_nbyte"] <= pipe.staging.nbyte_budget
    assert 0 <= stats["out_queue_depth"] <= pipe.out_queue.maxsize


def test_perf_timer_laps_are_spans():
    t = proclog.PerfTimer(stage="s")
    proclog.enable_spans(True)
    t0 = time.time_ns()
    t.tick()
    t.mark_acquire(3)
    t.mark_reserve(3)
    with proclog.span("s.work"):
        pass
    t.mark_process(10, 3)
    t.mark_acquire(4)
    t.tick()            # drops the reserve lap of window 4
    proclog.enable_spans(False)
    t.mark_acquire(5)   # spans off: the open lap closes, none opens
    recs = proclog.spans_between(t0, time.time_ns())
    assert [(r[0], r[3], r[4]) for r in recs] == [
        ("s.acquire", 3, None), ("s.reserve", 3, None),
        ("s.work", 3, "s.process"), ("s.process", 3, None),
        ("s.acquire", 4, None), ("s.acquire", 5, None)]
    assert t._open is None and proclog._stack() == []
