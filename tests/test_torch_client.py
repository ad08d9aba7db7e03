"""The port's operator client (``control/client.py``) and ``utils/
timeutils.py`` against the JAX package's: the cases of
``tests/test_control.py``, ``tests/test_output_control.py`` and
``tests/test_timeutils.py`` on the port, commands equal to the JAX
client's apart from the per-client nonce, and the dashboard text equal."""

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control import client as jctl
from caltech_bifrost_dsp_tpu.control import command as jcommand
from caltech_bifrost_dsp_tpu.control import monitor as jmonitor
from caltech_bifrost_dsp_tpu.control.store import MemoryStore as JStore
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.runtime.driver import XEnginePipeline as JPipe
from caltech_bifrost_dsp_tpu.utils import timeutils as jtime
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control import client as ctl
from caltech_bifrost_dsp_tpu_torch.control.command import (
    COMMAND_INVALID, COMMAND_NOT_RECOGNIZED, COMMAND_OK, COMMAND_WRONG_TYPE,
    CommandBlock)
from caltech_bifrost_dsp_tpu_torch.control.monitor import (MonitorBridge,
                                                           render_text)
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.utils import proclog, timeutils

torch.set_num_threads(1)

CFG = C.TINY
PCFG = TC.XEngineConfig(**dataclasses.asdict(CFG))
HOST = socket.gethostname()


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.set_id(0)
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


@pytest.fixture
def store():
    return MemoryStore()


def make_block(store, cls=CommandBlock, **kw):
    blk = cls("Corr", store=store, host="testhost", **kw)
    blk.define_command_key("acc_len", type=int, initial_val=2400,
                           condition=lambda x: x % 480 == 0)
    blk.define_command_key("start_time", type=int, initial_val=0,
                           condition=lambda x: x == -1 or x % 480 == 0)
    return blk


@pytest.mark.parametrize("t", [0.0, 1234.5, 1_700_000_000.0,
                               1_792_000_000.123])
def test_timeutils_match_jax(t):
    """tests/test_timeutils.py: the same spectra arithmetic."""
    s = timeutils.time_to_spectra(t)
    assert s == jtime.time_to_spectra(t) == int(t * 196_000_000) // 8192
    assert timeutils.spectra_to_time(s) == jtime.spectra_to_time(s)
    assert abs(timeutils.spectra_to_time(s) - t) < 2 * 4096 / 196e6
    args = (t + 3.0, 5.0, t, 23925.78125, 2400)
    start = timeutils.next_allowed_start(*args)
    assert start == jtime.next_allowed_start(*args)
    assert start % 2400 == 0
    assert 0 <= 8.0 * 23925.78125 - start < 2400


def test_command_roundtrip_and_staging(store):
    blk = make_block(store)
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    resp = cli.send_command("testhost", 0, "Corr", blk.instance_id,
                            acc_len=4800)
    assert resp["status"] == "normal"
    assert blk.command_vals["acc_len"] == 2400 and blk.update_pending
    blk.update_command_vals()
    assert blk.command_vals["acc_len"] == 4800
    assert not blk.update_pending
    with pytest.raises(RuntimeError, match="rejected"):
        cli.send_command("testhost", 0, "Corr", blk.instance_id, acc_len=7)
    with pytest.raises(ctl.CommandTimeout):
        cli.send_command("testhost", 0, "NoSuchBlock", 0, timeout_s=0.2,
                         acc_len=4800)
    with pytest.raises(ValueError):
        ctl.CorrControlClient()


def test_process_command_strings_matches_jax():
    """Rejection codes and error responses of the strings path, beside the
    JAX block fed the same strings."""
    jst, pst = JStore(), MemoryStore()
    jcommand.CommandBlock.reset_instance_counts()
    blocks = (make_block(jst, jcommand.CommandBlock), make_block(pst))
    cmds = [json.dumps({"cmd": "update", "id": "1", "val": {"kwargs": kw}})
            for kw in ({"nope": 1}, {"acc_len": "x"}, {"acc_len": 7},
                       {"acc_len": 960})]
    cmds += ["not json", json.dumps({"cmd": "update"}),
             json.dumps({"cmd": "bogus", "id": "1"})]
    seen = {0: [], 1: []}
    for k, (blk, st) in enumerate(zip(blocks, (jst, pst))):
        for c in cmds:
            blk.process_command_strings(c)
            resp = json.loads(st.get(blk.response_key))
            seen[k].append((blk.stats["last_cmd_response"],
                            resp["val"]["status"], resp["val"]["response"]))
        blk.process_command_strings(cmds[:4])  # a list is taken in order
    assert seen[1] == seen[0]
    assert [s[0] for s in seen[1][:4]] == [
        COMMAND_NOT_RECOGNIZED, COMMAND_WRONG_TYPE, COMMAND_INVALID,
        COMMAND_OK]
    assert blocks[1].command_vals == blocks[0].command_vals


def test_simulated_mode_matches_jax():
    """The command JSON is the JAX client's apart from the nonce in the
    sequence id, and a block takes it through the strings path."""
    jcli = jctl.CorrControlClient(simulated=True)
    pcli = ctl.CorrControlClient(simulated=True)
    calls = [dict(start_time=-1), dict(acc_len=4800),
             dict(coeffs={"type": "calgains", "input_id": 3, "beam_id": 1,
                          "data": [1.0, -2.0]}),
             dict(baselines=[[[0, 0], [1, 1]]])]
    for kw in calls:
        j = json.loads(jcli.send_command("h", 0, "Corr", 0, **kw))
        p = json.loads(pcli.send_command("h", 0, "Corr", 0, **kw))
        jn, _, jseq = j.pop("id").partition("-")
        pn, _, pseq = p.pop("id").partition("-")
        assert (len(pn), pseq) == (len(jn), jseq) and pn != jn
        assert p == j
    raw = pcli.send_command("h", 0, "Corr", 0, start_time=-1)
    blk = make_block(MemoryStore())
    blk.process_command_strings(raw)
    blk.update_command_vals()
    assert blk.command_vals["start_time"] == -1
    # the per-block handles build the JAX handles' commands
    jp = jctl.PipelineControl(jcli, "h", 0)
    pp = ctl.PipelineControl(pcli, "h", 0)
    g = np.arange(4) * (1 + 2j)
    for f in (lambda p: p.beamform.update_calibration_gains(1, 3, g),
              lambda p: p.beamform.update_delays(0, [1.5, -2.0], [1.0, 0.5],
                                                 load_sample=480),
              lambda p: p.triggered_dump.trigger(2400, 2, "/data"),
              lambda p: p.triggered_dump.abort(),
              lambda p: p.corr_output_full.enable_autos("/x"),
              lambda p: p.beamform_output.set_destinations(["1.2.3.4"],
                                                           [10000])):
        a, b = json.loads(f(jp)), json.loads(f(pp))
        assert a["val"] == b["val"]


def test_apply_immediately_mode(store):
    blk = make_block(store, apply_immediately=True)
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    cli.send_command("testhost", 0, "Corr", blk.instance_id, acc_len=9600)
    assert blk.command_vals["acc_len"] == 9600


def test_corrcontrol_handle(store):
    blk = make_block(store)
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    corr = ctl.CorrControl(cli, "testhost", 0, "Corr",
                           instance_id=blk.instance_id)
    corr.set_acc_length(4800)
    blk.update_command_vals()
    assert blk.command_vals["acc_len"] == 4800
    with pytest.raises(AssertionError):
        corr.set_acc_length(2400.0)


def test_arm_path_via_monitor_status(store):
    """get_next_allowed_start reads sync_time/bw_hz/nchan/xgpu_acc_len off
    the published status, and refuses before the first publish."""
    blk = make_block(store)
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    corr = ctl.CorrControl(cli, "testhost", 0, "Corr",
                           instance_id=blk.instance_id)
    with pytest.raises(RuntimeError, match="sync_time"):
        corr.get_next_allowed_start(5.0)
    blk.sequence_proclog.update({"sync_time": 1000.0,
                                 "bw_hz": 192 * 23925.78125,
                                 "nchan": 192, "seq0": 0})
    blk.update_stats({"state": "running", "curr_sample": 0,
                      "xgpu_acc_len": 480})
    MonitorBridge(store, host="testhost").publish_once()
    start = corr.get_next_allowed_start(5.0)
    assert start % 480 == 0 and start > 0
    want = jctl.CorrControl(jctl.CorrControlClient(store=store), "testhost",
                            0, "Corr").get_next_allowed_start(5.0)
    assert abs(want - start) <= 480 * 100


def test_monitor_dashboard_matches_jax(store):
    """The bridge's publish and ``render_text``: the port's text equals the
    JAX dashboard's over the same keys, the baselines sub-key skipped."""
    blk = make_block(store)
    blk.update_stats({"state": "running", "ngood_bytes": 0,
                      "baselines": [[[0, 0], [0, 0]]] * 4})
    bridge = MonitorBridge(store, host="testhost")
    bridge.publish_once()
    blk.update_stats({"ngood_bytes": 10_000_000})
    for k in bridge._prev_bytes:
        t, n = bridge._prev_bytes[k]
        bridge._prev_bytes[k] = (t - 1.0, n)
    out = bridge.publish_once()
    (key, payload), = [(k, v) for k, v in out.items() if "Corr" in k]
    assert payload["gbps"] > 0
    assert any(k.endswith("/baselines") for k in store.get_prefix("/mon"))
    txt = render_text(store)
    assert "state=running" in txt and "Corr" in txt
    assert txt == jmonitor.render_text(store)


def publish(store, pid, state, **stats):
    store.put(f"/mon/corr/x/testhost/pipeline/{pid}/Corr/0/status",
              json.dumps({"sync_time": 1000.0 - 2.0 * pid,
                          "bw_hz": 192 * 23925.78125, "nchan": 192,
                          "stats": {"state": state, "xgpu_acc_len": 480,
                                    **stats}}))


def corr_blocks(store, n):
    blks = []
    for pid in range(n):
        CommandBlock.set_id(pid)
        CommandBlock.reset_instance_counts()
        blk = CommandBlock("Corr", store=store, host="testhost")
        blk.define_command_key("acc_len", type=int, initial_val=2400,
                               condition=lambda x: x % 480 == 0)
        blk.define_command_key(
            "start_time", type=int, initial_val=0,
            condition=lambda x: x == -1 or x % 480 == 0)
        blks.append(blk)
    CommandBlock.set_id(0)
    return blks


def test_arm_and_wait_three_pipelines_with_skew(store):
    """Three pipelines with skewed clocks: one common start, aligned and in
    the future for each, verified waiting -> running."""
    blks = corr_blocks(store, 3)
    for pid in range(3):
        publish(store, pid, "running")
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    pls = [ctl.PipelineControl(cli, "testhost", pid) for pid in range(3)]
    corr = ctl.CorrelatorControl(cli, pls)
    expected = [p.corr.get_next_allowed_start(5.0) for p in pls]
    assert len(set(expected)) > 1
    stop = time.monotonic() + 10

    def run_block(pid, blk):
        armed = False
        while time.monotonic() < stop:
            if blk.update_pending:
                blk.update_command_vals()
                armed = True
                publish(store, pid, "waiting")
            elif armed:
                publish(store, pid, "running")
                return
            time.sleep(0.02)

    threads = [threading.Thread(target=run_block, args=(pid, b))
               for pid, b in enumerate(blks)]
    for t in threads:
        t.start()
    start = corr.arm_and_wait(delay_s=5.0, timeout_s=10.0)
    for t in threads:
        t.join()
    assert max(expected) <= start <= max(expected) + 480 * 100
    assert start % 480 == 0
    for blk in blks:
        assert blk.command_vals["start_time"] == start


def test_arm_and_wait_rejects_unarmed_running_pipeline(store):
    """A pipeline that acks the arm but never applies it stays 'running'
    on its old grid and fails the verification."""
    corr_blocks(store, 1)
    publish(store, 0, "running", curr_sample=10 ** 15, start_time=0,
            new_start_time=0)
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    corr = ctl.CorrelatorControl(cli, [ctl.PipelineControl(cli, "testhost",
                                                           0)])
    with pytest.raises(ctl.CommandTimeout):
        corr.arm_and_wait(delay_s=5.0, timeout_s=2.0)


def test_arm_and_wait_immediate_deadline_raises_timeout(store):
    corr_blocks(store, 1)
    publish(store, 0, "running")
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    corr = ctl.CorrelatorControl(cli, [ctl.PipelineControl(cli, "testhost",
                                                           0)])
    with pytest.raises(ctl.CommandTimeout):
        corr.arm_and_wait(delay_s=5.0, timeout_s=0.0)


def test_pipeline_is_up_and_autocorrs(store):
    cli = ctl.CorrControlClient(store=store, timeout_s=2.0)
    pl = ctl.PipelineControl(cli, "testhost", 0)
    assert not pl.pipeline_is_up()
    store.put("/mon/corr/x/testhost/pipeline/0/Corr/0/status",
              json.dumps({"time": time.time(), "stats": {}}))
    assert pl.pipeline_is_up()
    rng = np.random.RandomState(1)
    v = rng.randint(-4, 5, (6, 3, 8)) + 1j * rng.randint(-4, 5, (6, 3, 8))
    dense = np.einsum("tci,tcj->cij", v, v.conj())
    got = ctl.CorrelatorControl.autocorrs(dense, 4)
    np.testing.assert_array_equal(
        got, jctl.CorrelatorControl.autocorrs(dense, 4))
    assert got.shape == (4, 2, 3)


def test_dest_file_redirect_matches_jax(tmp_path):
    """tests/test_output_control.py::test_dest_file_redirect: the slow
    dump's packets go to a file through the client, in both drivers; the
    files are equal."""
    outs = {}
    for name, Pipe, Store, Client, cfg, src, snk, kw in (
            ("jax", JPipe, JStore, jctl.CorrControlClient, CFG,
             jsource.DummySource, jsink, {}),
            ("port", XEnginePipeline, MemoryStore, ctl.CorrControlClient,
             PCFG, source.SyntheticSource, sink, {"device": "cpu"})):
        st = Store()
        pipe = Pipe(cfg, src(cfg, mode="random"), store=st, sync_time=7,
                    corr_outputs=[snk.CorrFullOutput(cfg, send=None)], **kw)
        outs[name] = tmp_path / f"{name}.dat"
        pc = (jctl.PipelineControl if name == "jax" else
              ctl.PipelineControl)(Client(store=st, timeout_s=5.0), HOST, 0)
        pc.corr_output_full.set_dest_file(str(outs[name]))
        pipe.run(2 * cfg.acc_len_slow // cfg.ntime_gulp, timeout_s=300)
        assert pipe.ndump_slow == 2
    raw = outs["port"].read_bytes()
    assert raw == outs["jax"].read_bytes()
    nbl = PCFG.nstand * (PCFG.nstand + 1) // 2
    size = 56 + PCFG.npol * PCFG.npol * PCFG.nchan * 2 * 4
    assert len(raw) == 2 * nbl * size
    hdr, _ = pk.decode_corr_full(raw[:size])
    assert (hdr.stand0, hdr.stand1, hdr.acc_len) == (0, 0, PCFG.acc_len_slow)


def test_output_controls_through_the_client(tmp_path):
    """tests/test_output_control.py: baseline selection read back off the
    monitor sub-key, per-beam destination lists, emission disabled with
    0.0.0.0, autos written through ``enable_autos``."""
    st = MemoryStore()
    pkts = []
    corr_out = sink.CorrFullOutput(PCFG, send=pkts.append)
    pb = sink.PBeamOutput(PCFG, senders={})
    pipe = XEnginePipeline(PCFG, source.SyntheticSource(PCFG, mode="random"),
                           store=st, corr_outputs=[corr_out],
                           pbeam_outputs=[pb], device="cpu")
    pc = ctl.PipelineControl(ctl.CorrControlClient(store=st, timeout_s=5.0),
                             HOST, 0)
    new_bl = cs.default_baselines(PCFG.nvis_out, PCFG.nstand)
    new_bl[0] = [[1, 1], [2, 0]]
    pc.corr_subsel.set_baseline_select(new_bl)
    with pytest.raises(AssertionError):
        pc.corr_subsel.set_baseline_select(new_bl[:-1])
    nb2 = PCFG.nbeam // 2
    pc.beamform_output.set_destinations(
        ["127.0.0.1"] + ["0.0.0.0"] * (nb2 - 1), [19999] * nb2)
    pc.corr_output_full.set_destination("0.0.0.0", 1)
    pc.corr_output_full.enable_autos(str(tmp_path))
    pipe.run(PCFG.acc_len_slow // PCFG.ntime_gulp, timeout_s=300)
    assert pipe.ndump_slow == 1
    MonitorBridge(st, pipeline_id=0).publish_once()
    assert pc.corr_subsel.get_baseline_select() == new_bl
    assert set(pb.senders) == {0}
    assert pkts == []
    autos = np.load(tmp_path / "autos_0.npy")
    assert autos.shape == (PCFG.nstand, PCFG.npol, PCFG.nchan)
    assert (autos >= 0).all()
