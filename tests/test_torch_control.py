"""The port's control plane against ``caltech_bifrost_dsp_tpu/control``:
``CommandBlock`` staged application, responses and stats under the same
sequence of store writes; the driver's command blocks; the monitor bridge;
the in-process store."""

import dataclasses
import json

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control import command as jcommand
from caltech_bifrost_dsp_tpu.control import monitor as jmonitor
from caltech_bifrost_dsp_tpu.control import store as jstore
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.runtime import driver as jdriver
from caltech_bifrost_dsp_tpu.utils import proclog as jproclog
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control import command, monitor, store
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.runtime import driver
from caltech_bifrost_dsp_tpu_torch.utils import proclog

HOST = "xhost"
CFG = C.TINY
#: the port's config, from the JAX one field by field
PCFG = TC.XEngineConfig(**dataclasses.asdict(CFG))


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    command.CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def _put(st, key, value):
    st.put(key, value if isinstance(value, str) else json.dumps(value))


def _cmd(seq, **kw):
    return {"cmd": "update", "id": seq, "val": {"kwargs": kw}}


WRITES = [
    _cmd(1, acc_len=480),                       # staged
    _cmd(2, acc_len="480"),                     # wrong type
    _cmd(3, nope=1),                            # not recognized
    _cmd(4, acc_len=481),                       # fails the condition
    _cmd(5, acc_len=960, start_time=7),         # one key invalid: nothing
    "{not json",
    {"cmd": "update", "val": {"kwargs": {}}},   # missing id
    {"cmd": "delete", "id": 6},
    {"cmd": "update", "id": 7, "val": 3},
    {"cmd": "update", "id": 8, "val": {"kwargs": 3}},
    _cmd(9, start_time=96, acc_len=720),        # staged, replaces 1
]


def _responses(st, key):
    r = json.loads(st.get(key))
    return r["id"], r["val"]["status"], r["val"]["response"]


def _pair(cls_j, cls_p, *args, **kw):
    jst, pst = jstore.MemoryStore(), store.MemoryStore()
    jb = cls_j(*args, store=jst, host=HOST, **kw)
    pb = cls_p(*args, store=pst, host=HOST, **kw)
    return (jb, jst), (pb, pst)


def _blocks():
    """A Corr-like block with typed, conditioned keys in both packages."""
    def make(cls):
        class Corr(cls):
            def __init__(self, store, host):
                super().__init__("Corr", store=store, host=host)
                self.define_command_key(
                    "start_time", type=int, initial_val=0,
                    condition=lambda x: x == -1 or x % 48 == 0)
                self.define_command_key("acc_len", type=int,
                                        initial_val=240,
                                        condition=lambda x: x % 48 == 0)
        return Corr
    return _pair(make(jcommand.CommandBlock), make(command.CommandBlock))


def _stats(block):
    return {k: v for k, v in block.stats.items() if "time" not in k}


def test_staged_application_matches_jax():
    (jb, jst), (pb, pst) = _blocks()
    assert pb.command_key == jb.command_key
    assert pb.response_key == jb.response_key
    for w in WRITES:
        _put(jst, jb.command_key, w)
        _put(pst, pb.command_key, w)
        assert _responses(pst, pb.response_key) == \
            _responses(jst, jb.response_key)
        # nothing takes effect before the data path applies it
        assert pb.command_vals == jb.command_vals == \
            {"start_time": 0, "acc_len": 240}
        assert pb.update_pending == jb.update_pending
        assert _stats(pb) == _stats(jb)
    assert pb.update_pending
    pb.update_command_vals()
    jb.update_command_vals()
    assert pb.command_vals == jb.command_vals == \
        {"start_time": 96, "acc_len": 720}
    assert not pb.update_pending
    assert _stats(pb) == _stats(jb)
    snap = proclog.registry_snapshot()["Corr/stats"]
    assert snap["acc_len"] == 720 and snap["update_pending"] is False
    pb.close()
    _put(pst, pb.command_key, _cmd(10, acc_len=48))
    assert _responses(pst, pb.response_key)[0] == 9


def test_immediate_block_hook_sees_each_key_once():
    seen = {"j": [], "p": []}

    def make(cls, tag):
        class Dump(cls):
            def __init__(self, store, host):
                super().__init__("TriggeredDump", store=store, host=host,
                                 apply_immediately=True)
                self.define_command_key("command", type=str, initial_val="")
                self.define_command_key("nfile", type=int, initial_val=1)
                self._on_command_applied = seen[tag].append
        return Dump

    (jb, jst), (pb, pst) = _pair(make(jcommand.CommandBlock, "j"),
                                 make(command.CommandBlock, "p"))
    for w in [_cmd(1, command="trigger"), _cmd(2, nfile=3),
              _cmd(3, nfile="x")]:
        _put(jst, jb.command_key, w)
        _put(pst, pb.command_key, w)
    assert seen["p"] == seen["j"] == [{"command": "trigger"}, {"nfile": 3}]
    assert pb.command_vals == jb.command_vals
    assert not pb.update_pending


def test_instance_ids_and_initial_value_checks():
    a = command.CommandBlock("Out", host=HOST)
    b = command.CommandBlock("Out", host=HOST)
    assert (a.instance_id, b.instance_id) == (0, 1)
    assert b.command_key.endswith("/Out/1")
    assert "Out.1/stats" in proclog.registry_snapshot()
    command.CommandBlock.set_id(3)
    try:
        assert "/pipeline/3/" in command.CommandBlock("X", host=HOST) \
            .command_key
    finally:
        command.CommandBlock.set_id(0)
    with pytest.raises(TypeError):
        a.define_command_key("k", type=int, initial_val="1")
    with pytest.raises(ValueError):
        a.define_command_key("k", type=int, initial_val=3,
                             condition=lambda x: x > 5)


def test_store_matches_jax_and_connect():
    jst, pst = jstore.MemoryStore(), store.MemoryStore()
    events = {"j": [], "p": []}
    wj = jst.add_watch_prefix_callback(
        "/a/", lambda r: events["j"].extend((e.key, e.value)
                                            for e in r.events))
    wp = pst.add_watch_prefix_callback(
        "/a/", lambda r: events["p"].extend((e.key, e.value)
                                            for e in r.events))
    for st in (jst, pst):
        st.put("/a/1", "x")
        st.put("/b/1", "y")
        st.put("/a/2", "z")
        st.delete("/a/1")
    jst.cancel_watch(wj)
    pst.cancel_watch(wp)
    jst.put("/a/3", "w")
    pst.put("/a/3", "w")
    assert events["p"] == events["j"] == [("/a/1", "x"), ("/a/2", "z")]
    assert pst.get_prefix("/") == jst.get_prefix("/")
    assert pst.get("/a/1") is None
    assert isinstance(store.connect(None), store.MemoryStore)
    with pytest.raises(NotImplementedError, match="not ported"):
        store.connect("etcd-host")


def test_monitor_bridge_matches_jax():
    jproclog.clear_registry()
    (jb, jst), (pb, pst) = _blocks()
    for b in (jb, pb):
        b.update_stats({"state": "running", "ngood_bytes": 1000,
                        "baselines": [[[0, 0], [1, 1]]]})
        b.sequence_proclog.update({"sync_time": 5, "nchan": 16})
        b.perf_proclog.update({"gbps": 1.5})
    bridges = (jmonitor.MonitorBridge(jst, pipeline_id=2, host=HOST),
               monitor.MonitorBridge(pst, pipeline_id=2, host=HOST))
    for k in range(2):
        outs = [br.publish_once() for br in bridges]
        assert outs[1].keys() == outs[0].keys()
        for key in outs[0]:
            a = {x: v for x, v in outs[0][key].items()
                 if x not in ("time", "gbps")}
            b = {x: v for x, v in outs[1][key].items()
                 if x not in ("time", "gbps")}
            assert b == a
            assert ("gbps" in outs[1][key]) == ("gbps" in outs[0][key])
    key = next(iter(outs[1]))
    assert json.loads(pst.get(key + "/baselines")) == [[[0, 0], [1, 1]]]
    bridges[1].poll_s = 0.01
    bridges[1].start()
    bridges[1].stop()


def test_perf_timer_publishes_the_taxonomy():
    log = proclog.ProcLog("Stage/perf")
    t = proclog.PerfTimer(log)
    t.tick()
    t.mark_acquire()
    t.mark_reserve()
    t.mark_process(10 ** 6)
    rec = t.publish()
    assert set(rec) == set(jproclog.PerfTimer().publish())
    assert log.snapshot() == rec and rec["gbps"] > 0
    t.reset()
    assert t.gbps == 0.0 and t.nbyte == 0


def test_output_command_blocks_match_jax(tmp_path):
    """dest_file / dest_ip / max_mbps on a COR sink and per-beam
    destinations on a PBEAM sink take effect like the JAX blocks'."""
    jout = jsink.CorrFullOutput(CFG, max_mbps=100)
    pout = sink.CorrFullOutput(PCFG, max_mbps=100)
    jst, pst = jstore.MemoryStore(), store.MemoryStore()
    jb = jdriver.OutputCommandBlock("CorrOutputFull", jout, store=jst)
    pb = driver.OutputCommandBlock("CorrOutputFull", pout, store=pst)
    out = tmp_path / "cor.bin"
    for w in [_cmd(1, dest_file=str(out), max_mbps=200)]:
        _put(jst, jb.command_key, w)
        _put(pst, pb.command_key, w)
    for b in (jb, pb):
        b.apply_pending()
    assert pout.throttle.max_bps == jout.throttle.max_bps == 2e8
    pout.send(b"abc")
    assert out.read_bytes() == b"abc"
    _put(pst, pb.command_key, _cmd(2, dest_file="", dest_ip="127.0.0.1",
                                   dest_port=9))
    pb.apply_pending()
    assert isinstance(pout.send, sink.UdpSender)
    assert pout.send.dest == ("127.0.0.1", 9)
    _put(pst, pb.command_key, _cmd(3, dest_ip="0.0.0.0", dest_file=str(
        tmp_path / "no" / "such" / "dir")))
    pb.apply_pending()
    assert pout.send is None and "last_apply_error" in pb.stats

    ib = sink.IBeamOutput(PCFG)
    ob = driver.OutputCommandBlock("BeamformVlbiOutput", ib,
                                   store=store.MemoryStore())
    _put(ob.store, ob.command_key, _cmd(1, max_mbps=10 ** 5))
    ob.apply_pending()
    assert ib.throttle.max_bps == sink.IBeamOutput.MAX_BPS

    jpb, ppb = jsink.PBeamOutput(CFG), sink.PBeamOutput(PCFG)
    jb = jdriver.BeamOutputCommandBlock(jpb, 2, store=jst)
    pb = driver.BeamOutputCommandBlock(ppb, 2, store=pst)
    w = _cmd(1, dest_ip=["127.0.0.1", "0.0.0.0"], dest_port=[7000, 7001])
    _put(jst, jb.command_key, w)
    _put(pst, pb.command_key, w)
    jb.apply_pending()
    pb.apply_pending()
    assert sorted(ppb.senders) == sorted(jpb.senders) == [0]
    assert ppb.senders[0].dest == jpb.senders[0].dest


def test_fengine_block_matches_jax():
    jb = jdriver.FEngineCommandBlock(CFG, 0.5, store=jstore.MemoryStore())
    pb = driver.FEngineCommandBlock(PCFG, 0.5, store=store.MemoryStore())
    eq = list(np.linspace(0.5, 2.0, CFG.nchan))
    for w in [_cmd(1, eq_gains=eq, quant_scale=2), _cmd(2, eq_gains=[1.0]),
              _cmd(3, quant_scale=-1.0)]:
        _put(jb.store, jb.command_key, w)
        _put(pb.store, pb.command_key, w)
    assert pb.apply_pending() and jb.apply_pending()
    np.testing.assert_array_equal(pb.scale_device.numpy(),
                                  np.asarray(jb.scale_device))
    assert {k: pb.stats[k] for k in ("quant_scale", "eq_gains_set")} == \
        {k: jb.stats[k] for k in ("quant_scale", "eq_gains_set")}
    assert not pb.apply_pending()


def test_beamform_and_subsel_blocks_match_jax():
    """Calibration gains, a delayed beam load, a malformed command and a
    baseline selection reach the same active gains and pairs."""
    jb = jdriver.BeamformCommandBlock(CFG, store=jstore.MemoryStore())
    pb = driver.BeamformCommandBlock(PCFG, store=store.MemoryStore())
    rng = np.random.RandomState(7)
    data = rng.randint(-8, 9, 2 * CFG.nchan).astype(float).tolist()
    delays = rng.uniform(0, 50, CFG.ninput).tolist()
    writes = [
        _cmd(1, coeffs={"type": "calgains", "input_id": 3, "beam_id": 1,
                        "data": data}),
        _cmd(2, coeffs={"type": "beamcoeffs", "beam_id": 1,
                        "data": {"delays": delays,
                                 "amps": [2.0] * CFG.ninput},
                        "load_sample": 480}),
        _cmd(3, coeffs={"type": "calgains", "input_id": 99, "beam_id": 0,
                        "data": data}),
    ]
    for w in writes:
        _put(jb.store, jb.command_key, w)
        _put(pb.store, pb.command_key, w)
    assert pb.stats["last_cmd_error"] and jb.stats["last_cmd_error"]
    for t in (0, 240, 480):
        assert pb.stage_loads(t) == jb.stage_loads(t)
        g = pb.device_gains()
        jg = jb.device_gains()
        np.testing.assert_array_equal(g.real.numpy(), np.asarray(jg.real))
        np.testing.assert_array_equal(g.imag.numpy(), np.asarray(jg.imag))
    assert np.abs(pb.gains_active[:, 1]).sum() > 0
    assert pb.stats["cal_gains1"] == jb.stats["cal_gains1"]

    js = jdriver.SubselCommandBlock(CFG, store=jstore.MemoryStore())
    ps = driver.SubselCommandBlock(PCFG, store=store.MemoryStore())
    bl = [[[k % 16, 1], [(3 * k) % 16, 0]] for k in range(CFG.nvis_out)]
    for w in [_cmd(1, baselines=bl[:5]), _cmd(2, baselines=bl)]:
        _put(js.store, js.command_key, w)
        _put(ps.store, ps.command_key, w)
    assert ps.apply_pending() and js.apply_pending()
    np.testing.assert_array_equal(ps.pairs_device.numpy(),
                                  np.asarray(js.pairs_device))
    assert ps.stats["baselines"] == js.stats["baselines"] == bl
