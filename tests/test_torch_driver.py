"""The port's ``XEnginePipeline`` against the JAX ``XEnginePipeline``.

Both drivers run on the CPU over the same synthetic stream with the same
sinks (packets collected through ``send``) and the same commands.
Visibility (COR) and subselection packets must be byte-identical; beam
packets are decoded and must be equal (integer gains make every beam sum
exact).  The JAX driver runs its engines as its own tests do (Pallas in
interpret mode).  Commands are issued from inside both compute threads at
the same stream sample, through the control store, so that they land at
the same gulp in both.

Also here: the golden checkfile gate, a sequence break, and the CLI
(``--subsel-dest`` on a loopback socket; ``--etcdhost``, ``--bufgbytes``
and ``--dump-direct`` run; ``--mesh`` on a host without the CUDA devices
exits 2).
"""

import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control.store import MemoryStore as JStore
from caltech_bifrost_dsp_tpu.io import packets as jpk
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.runtime.driver import XEnginePipeline as JPipe
from caltech_bifrost_dsp_tpu.scripts import pipeline as jcli
from caltech_bifrost_dsp_tpu.verification import golden as jgolden
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.io import source
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.scripts import pipeline
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)



def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


CFG = C.TINY
PCFG = port_cfg(CFG)
SYNC = 1_700_000_000
ENGINES = {
    "triu": dict(corr_engine="pallas_triu", subsel_engine="pallas",
                 bf_engine="pallas"),
    "tpu": dict(C.TPU_ENGINES),
}
# FX: two gulps per fast window, two fast windows per slow window
FX_CFG = C.XEngineConfig(nstand=8, nchan=16, ntime_gulp=48, acc_len=96,
                         acc_len_slow=192, nbeam=2, ntime_sum=12,
                         nchan_sum=4, pfb_ntap=4, adc_dtype="int8")


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def command(store, key, seq, **kwargs):
    store.put(key, json.dumps({"cmd": "update", "id": seq,
                               "val": {"kwargs": kwargs}}))


def gain_commands(cfg, seed):
    """calgains for every (beam, input) with integers in [-8, 8], then a
    zero-delay unit-amplitude load of every beam."""
    rng = np.random.RandomState(seed)
    cmds = []
    for b in range(cfg.nbeam):
        for i in range(cfg.ninput):
            data = np.empty(2 * cfg.nchan)
            data[0::2] = rng.randint(-8, 9, cfg.nchan)
            data[1::2] = rng.randint(-8, 9, cfg.nchan)
            cmds.append({"type": "calgains", "input_id": i, "beam_id": b,
                         "data": data.tolist()})
    for b in range(cfg.nbeam):
        cmds.append({"type": "beamcoeffs", "beam_id": b,
                     "data": {"delays": [0.0] * cfg.ninput,
                              "amps": [1.0] * cfg.ninput},
                     "load_sample": -1})
    return cmds


def new_baselines(cfg, seed):
    rng = np.random.RandomState(seed)
    return [[[int(rng.randint(cfg.nstand)), int(rng.randint(2))],
             [int(rng.randint(cfg.nstand)), int(rng.randint(2))]]
            for _ in range(cfg.nvis_out)]


class Collect:
    """Packets of every sink of one pipeline."""

    def __init__(self):
        self.cor, self.sub, self.pb, self.ib = [], [], [], []


def sinks(mod, cfg, got: Collect, checkfile=None):
    return dict(
        corr_outputs=[mod.CorrFullOutput(
            cfg, send=got.cor.append, use_cor_fmt=True, checkfile=checkfile,
            checkfile_acc_len=cfg.acc_len)],
        subsel_outputs=[mod.CorrPartOutput(cfg, send=got.sub.append)],
        pbeam_outputs=[mod.PBeamOutput(
            cfg, senders={b: got.pb.append for b in range(cfg.nbeam // 2)})],
        ibeam_outputs=[mod.IBeamOutput(cfg, send=got.ib.append)])


def make_pipes(cfg, jsrc, psrc, checkfile=None, **kw):
    """(JAX pipeline, port pipeline, their collectors and stores)."""
    jgot, pgot = Collect(), Collect()
    jstore, pstore = JStore(), MemoryStore()
    pcfg = port_cfg(cfg)
    jp = JPipe(cfg, jsrc, store=jstore, sync_time=SYNC,
               **sinks(jsink, cfg, jgot, checkfile), **kw)
    pp = XEnginePipeline(pcfg, psrc, store=pstore, sync_time=SYNC,
                         device="cpu", **sinks(sink, pcfg, pgot, checkfile),
                         **kw)
    return (jp, jstore, jgot), (pp, pstore, pgot)


def at_sample(pipe, store, t_fire, fire):
    """Call ``fire(pipe, store)`` from the compute thread when it stages
    coefficient loads at stream sample ``t_fire``."""
    orig = pipe.beam_cmd.stage_loads

    def stage_loads(t):
        if t == t_fire:
            fire(pipe, store)
        return orig(t)

    pipe.beam_cmd.stage_loads = stage_loads


def load_gains(pipe, store, cfg, seed):
    for k, c in enumerate(gain_commands(cfg, seed)):
        command(store, pipe.beam_cmd.command_key, f"g{seed}-{k}", coeffs=c)


def assert_same_packets(jgot: Collect, pgot: Collect):
    assert pgot.cor == jgot.cor
    assert pgot.sub == jgot.sub
    assert len(pgot.pb) == len(jgot.pb) and len(pgot.ib) == len(jgot.ib)
    for a, b in zip(pgot.pb, jgot.pb):
        ha, da = pk.decode_pbeam(a)
        hb, db = jpk.decode_pbeam(b)
        assert ha == pk.PBeamHeader(**vars(hb))
        np.testing.assert_array_equal(da, db)
    for a, b in zip(pgot.ib, jgot.ib):
        ha, da = pk.decode_ibeam(a)
        hb, db = jpk.decode_ibeam(b)
        assert ha == pk.IBeamHeader(**vars(hb))
        np.testing.assert_array_equal(da, db)


@pytest.mark.parametrize("engines", sorted(ENGINES))
def test_driver_packets_match_jax_under_commands(engines):
    """Integer gains loaded before the run; at sample 2 * acc_len new
    gains (loaded at once), a new baseline selection and a doubled fast
    acc_len (both staged to the next window boundary) are commanded."""
    cfg = CFG.replace(**ENGINES[engines])
    (jp, js, jgot), (pp, ps, pgot) = make_pipes(
        cfg, jsource.DummySource(cfg, mode="random", seed=11),
        source.SyntheticSource(port_cfg(cfg), mode="random", seed=11))
    baselines = new_baselines(cfg, 12)

    def mid_run_commands(pipe, store):
        load_gains(pipe, store, cfg, 13)
        command(store, pipe.subsel_cmd.command_key, "b", baselines=baselines)
        command(store, pipe.corr_cmd.command_key, "a",
                acc_len=2 * cfg.acc_len, start_time=-1)

    for pipe, store in ((jp, js), (pp, ps)):
        load_gains(pipe, store, cfg, 10)
        at_sample(pipe, store, 2 * cfg.acc_len, mid_run_commands)
    ngulp = 6 * cfg.acc_len_slow // cfg.ntime_gulp
    jp.run(ngulp, timeout_s=300)
    pp.run(ngulp, timeout_s=300)
    assert (pp.ndump_fast, pp.ndump_slow) == (jp.ndump_fast, jp.ndump_slow)
    assert pp.ndump_slow >= 3
    assert pp.subsel_cmd.baselines == baselines
    assert_same_packets(jgot, pgot)
    # the old cadence runs out its window; the new one starts on the next
    # boundary of its own grid
    heads = {(h.spectra_id, h.acc_len) for h, _, _ in
             map(pk.decode_corr_part, pgot.sub)}
    assert (2 * cfg.acc_len, cfg.acc_len) in heads
    assert (4 * cfg.acc_len, 2 * cfg.acc_len) in heads
    powers = np.array([pk.decode_pbeam(p)[1] for p in pgot.pb])
    assert np.abs(powers).sum() > 0


def test_driver_fx_packets_match_jax():
    cfg = FX_CFG.replace(pfb_fft_impl="matmul")
    (jp, js, jgot), (pp, ps, pgot) = make_pipes(
        cfg, jsource.ADCSource(cfg, amplitude=32.0, seed=21),
        source.ADCSource(port_cfg(cfg), amplitude=32.0, seed=21),
        fx_mode=True,
        quant_scale=0.1)
    for pipe, store in ((jp, js), (pp, ps)):
        load_gains(pipe, store, cfg, 22)
    ngulp = 3 * cfg.acc_len_slow // cfg.ntime_gulp
    jp.run(ngulp, timeout_s=300)
    pp.run(ngulp, timeout_s=300)
    assert pp.ndump_slow == jp.ndump_slow == 3
    assert_same_packets(jgot, pgot)


class _JumpJ(jsource.DummySource):
    """A stream that skips 3 gulps after gulp 7."""

    def stream(self, ngulp, seq0=0):
        for k in range(ngulp):
            jump = 3 if k > 7 else 0
            yield seq0 + (k + jump) * self.cfg.ntime_gulp, self.gulp(k)


class _JumpP(source.SyntheticSource):
    def stream(self, ngulp, seq0=0):
        for k in range(ngulp):
            jump = 3 if k > 7 else 0
            yield seq0 + (k + jump) * self.cfg.ntime_gulp, self.gulp(k)


def test_sequence_break_rearms_like_jax():
    cfg = CFG.replace(corr_engine="xla", subsel_engine="xla",
                      bf_engine="xla")
    (jp, js, jgot), (pp, ps, pgot) = make_pipes(
        cfg, _JumpJ(cfg, mode="random", seed=31),
        _JumpP(port_cfg(cfg), mode="random", seed=31))
    for pipe, store in ((jp, js), (pp, ps)):
        load_gains(pipe, store, cfg, 32)
    # the re-armed start lies 10 windows past the break
    jp.run(80, timeout_s=300)
    pp.run(80, timeout_s=300)
    assert pp.ndump_fast == jp.ndump_fast > 1
    assert_same_packets(jgot, pgot)
    spectra = {pk.decode_corr_part(p)[0].spectra_id for p in pgot.sub}
    assert min(spectra) == 0 and max(spectra) > 11 * cfg.ntime_gulp


def test_golden_checkfile_gate(tmp_path):
    cfg = PCFG
    ntime = 2 * cfg.acc_len_slow
    inp, corr = str(tmp_path / "in.dat"), str(tmp_path / "corr.dat")
    jgolden.write_input_file(inp, ntime, cfg.nchan, cfg.nstand, cfg.npol,
                             cfg.acc_len)
    jgolden.write_corr_file(corr, ntime, cfg.nchan, cfg.nstand, cfg.npol,
                            cfg.acc_len)
    got = Collect()
    out = sinks(sink, cfg, got, checkfile=corr)
    pp = XEnginePipeline(cfg, source.SyntheticSource(cfg, mode="testfile",
                                                     testfile=inp),
                         device="cpu", selftest=True, **out)
    pp.run(ntime // cfg.ntime_gulp, timeout_s=300)
    full = out["corr_outputs"][0]
    assert full.check_count == pp.ndump_slow == 2
    assert full.check_failures == 0
    assert pp.selftest_count == pp.ndump_fast and pp.selftest_failures == 0
    # the COR packets scatter back to the golden integration
    nbl = cfg.nstand * (cfg.nstand + 1) // 2
    cube = pk.cor_scatter_matrix(got.cor[:nbl], cfg.nstand)
    meta, want = jgolden.read_dat(corr)
    w = want[:cfg.acc_len_slow // cfg.acc_len].sum(0)  # [c, s, s, p, p]
    np.testing.assert_array_equal(cube[..., 0],
                                  w.real.transpose(1, 2, 3, 4, 0))
    np.testing.assert_array_equal(cube[..., 1],
                                  w.imag.transpose(1, 2, 3, 4, 0))


def test_per_gulp_mode_equals_batched():
    cfg = PCFG
    runs = []
    for batch in (True, False):
        CommandBlock.reset_instance_counts()
        got = Collect()
        store = MemoryStore()
        pp = XEnginePipeline(cfg, source.SyntheticSource(
            cfg, mode="random", seed=41), store=store, device="cpu",
            sync_time=SYNC, batch_accumulations=batch,
            **sinks(sink, cfg, got))
        load_gains(pp, store, cfg, 42)
        pp.run(2 * cfg.acc_len_slow // cfg.ntime_gulp, timeout_s=300)
        runs.append(got)
    assert runs[0].cor == runs[1].cor and runs[0].sub == runs[1].sub
    # per-gulp calls emit the beams gulp by gulp: same packets, another
    # order across beams
    assert runs[0].ib == runs[1].ib
    assert sorted(runs[0].pb) == sorted(runs[1].pb)


@pytest.mark.parametrize("arg", ["mesh", "history_nbyte", "dump_direct"])
def test_unported_driver_options_raise(arg):
    """What the driver refuses.  ``mesh=`` is ported
    (tests/test_torch_mesh_driver.py): a mesh on another device type than
    ``device`` raises.  The history ring is ported
    (tests/test_torch_trigger.py): a ring smaller than one frame raises,
    with or without ``dump_direct``, as in the JAX driver.  The stub device
    (``stub_device_ms=``) is ported: ``test_stub_device_matches_jax``."""
    from caltech_bifrost_dsp_tpu_torch.parallel.mesh import make_mesh

    kwargs = {"mesh": {"mesh": make_mesh(1, 1, devices=["cpu"])},
              "history_nbyte": {"history_nbyte": 1},
              "dump_direct": {"dump_direct": True,
                              "history_nbyte": PCFG.gulp_nbyte - 1}}[arg]
    device = "cuda" if arg == "mesh" else "cpu"
    with pytest.raises(ValueError):
        XEnginePipeline(PCFG, source.SyntheticSource(PCFG), device=device,
                        **kwargs)
    if arg in ("history_nbyte", "dump_direct"):
        with pytest.raises(ValueError):
            JPipe(CFG, jsource.DummySource(CFG), **kwargs)


@pytest.mark.parametrize("fx", [False, True], ids=["xb", "fx"])
def test_stub_device_matches_jax(fx, monkeypatch):
    """``stub_device_ms=``: both drivers on the CPU with every sink give the
    same dumps and the same packets (a zero subselection on each fast dump,
    zero COR planes on each slow dump, no beams); the port's stub sleeps
    ``stub_device_ms`` a whole window (in FX mode too, the spectra counted
    in ADC), runs no step, allocates no accumulator state and lets no
    kernel wrapper count a launch."""
    from caltech_bifrost_dsp_tpu_torch.models import xengine as txe
    from caltech_bifrost_dsp_tpu_torch.ops import beamform as tbf
    from caltech_bifrost_dsp_tpu_torch.ops import corr_acc as tca
    from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as tcs
    from caltech_bifrost_dsp_tpu_torch.runtime import driver as tdriver

    def no_step(*a, **k):
        raise AssertionError("the stub device ran a step")

    monkeypatch.setattr(txe, "xengine_step", no_step)
    monkeypatch.setattr(txe, "fx_step", no_step)
    sleeps = []
    monkeypatch.setattr(tdriver, "time", types.SimpleNamespace(
        sleep=sleeps.append, perf_counter=time.perf_counter))
    counters = [(tca.corr_acc, "launches"), (tca.corr_acc, "cached_launches"),
                (tbf.beamform_products, "launches"),
                (tcs.corr_subsel, "launches")]
    before = [getattr(f, c) for f, c in counters]
    if fx:
        cfg = FX_CFG
        srcs = (jsource.ADCSource(cfg, amplitude=32.0, seed=21),
                source.ADCSource(port_cfg(cfg), amplitude=32.0, seed=21))
    else:
        cfg = CFG
        srcs = (jsource.DummySource(cfg, mode="ramp"),
                source.SyntheticSource(PCFG, mode="ramp"))
    (jp, _, jgot), (pp, _, pgot) = make_pipes(cfg, *srcs, fx_mode=fx,
                                              stub_device_ms=2.5)
    assert pp.state is None
    ngulp = 2 * cfg.acc_len_slow // cfg.ntime_gulp
    jp.run(ngulp, timeout_s=300)
    pp.run(ngulp, timeout_s=300)
    assert (pp.ndump_fast, pp.ndump_slow) == (jp.ndump_fast, jp.ndump_slow)
    assert pp.ndump_slow == 2
    assert sleeps == [2.5e-3] * pp.ndump_fast
    # the compute thread's perf split counts the same processed bytes
    assert pp.perf_compute.nbyte == jp.perf_compute.nbyte > 0
    assert pgot.sub and not pgot.pb and not pgot.ib
    for p in pgot.sub:
        assert not pk.decode_corr_part(p)[2].any()
    assert_same_packets(jgot, pgot)
    assert [getattr(f, c) for f, c in counters] == before


def test_stub_device_refuses_the_selftest():
    with pytest.raises(ValueError):
        XEnginePipeline(PCFG, source.SyntheticSource(PCFG), device="cpu",
                        stub_device_ms=1.0, selftest=True)


def test_stage_failure_is_raised_by_run():
    class Broken(sink.CorrPartOutput):
        def send_subsel(self, *a, **k):
            raise OSError("sink down")

    pp = XEnginePipeline(PCFG, source.SyntheticSource(PCFG), device="cpu",
                         subsel_outputs=[Broken(PCFG, send=print)])
    with pytest.raises(RuntimeError, match="stage failed"):
        pp.run(40, timeout_s=120)


def test_cli_subsel_over_loopback_matches_jax_driver():
    """The port's CLI on the CPU sends subselection packets to a loopback
    socket; decoded, they equal the JAX driver's on the same ramp."""
    rx = sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=4, timeout_s=0.2)
    port = rx.getsockname()[1]
    args = ["--fakesource", "--nstand", "16", "--nchan", "16", "--nbeam",
            "4", "--ntime_gulp", "48", "--acc_len", "240", "--acc_len_slow",
            "480", "--ngulp", "20"]
    received = []
    done = threading.Event()

    def receive():
        while True:
            try:
                received.append(rx.recv(65536))
            except OSError:
                if done.is_set():
                    return

    th = threading.Thread(target=receive)
    th.start()
    try:
        rc = pipeline.main(args + ["--device", "cpu", "--subsel-dest",
                                   f"127.0.0.1:{port}", "-q"])
    finally:
        done.set()
        th.join()
        rx.close()
    assert rc == 0
    cfg = C.XEngineConfig(nstand=16, nchan=16, nbeam=4, ntime_gulp=48,
                          acc_len=240, acc_len_slow=480)
    want = []
    jp = JPipe(cfg, jsource.DummySource(cfg, mode="ramp"), sync_time=SYNC,
               subsel_outputs=[jsink.CorrPartOutput(cfg, send=want.append)])
    jp.run(20, timeout_s=300)
    assert len(received) == len(want) > 0
    for a, b in zip(received, want):
        ha, bla, da = pk.decode_corr_part(a)
        hb, blb, db = jpk.decode_corr_part(b)
        assert (ha.spectra_id, ha.acc_len, ha.nvis) == \
            (hb.spectra_id, hb.acc_len, hb.nvis)
        np.testing.assert_array_equal(bla, blb)
        np.testing.assert_array_equal(da, db)
    assert jcli.build_parser().parse_args([]).max_mbps == \
        pipeline.build_parser().parse_args([]).max_mbps


@pytest.mark.parametrize("extra", [
    ["--mesh", "2x4"], ["--xdp", "eth0"], ["--etcdhost", "kv://"],
    ["--bufgbytes", "0.001"], ["--dump-direct", "--bufgbytes", "0.001"],
    ["--no-fakesource"]])
def test_cli_unported_flags_exit_2(extra, capsys):
    """Every flag is ported now.  ``--mesh``, ``--xdp`` and capture (no
    ``--fakesource``) exit 2 only for want of the CUDA devices they would
    run on, before any socket is bound (capture on the CPU:
    ``tests/test_torch_over_the_wire.py``).  ``--etcdhost`` (a ``kv://``
    store here), ``--bufgbytes`` and ``--dump-direct`` run on the CPU and
    exit 0 (their pipeline commanded and triggered:
    ``tests/test_torch_manager.py``)."""
    if extra in (["--xdp", "eth0"], ["--no-fakesource"]):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        extra = [] if extra == ["--no-fakesource"] else extra
        assert pipeline.main(["--device", "cuda", "--ngulp", "1"]
                             + extra) == 2
        assert "no CUDA device" in capsys.readouterr().err
        return
    if extra != ["--mesh", "2x4"]:
        from caltech_bifrost_dsp_tpu_torch.control.netstore import \
            StoreServer

        srv = StoreServer(port=0)
        if extra[0] == "--etcdhost":
            extra = ["--etcdhost", f"kv://127.0.0.1:{srv.port}"]
        try:
            rc = pipeline.main(["--fakesource", "--device", "cpu", "--nstand",
                                "16", "--nchan", "16", "--nbeam", "4",
                                "--ntime_gulp", "48", "--acc_len", "240",
                                "--acc_len_slow", "480", "--ngulp", "20",
                                "-q"] + extra)
            watchers = len(srv.hub.watchers)
        finally:
            srv.close()
        assert rc == 0
        assert "4 fast dumps, 2 slow dumps" in capsys.readouterr().out
        # Corr, CorrAcc, Beamform and CorrSubsel watch their keys there
        assert (watchers >= 4) == (extra[0] == "--etcdhost")
        return
    # --mesh exits 2 only for want of CUDA devices
    if torch.cuda.device_count() >= 8:
        pytest.skip("8 CUDA devices are present")
    with pytest.raises(SystemExit) as exc:
        pipeline.main(["--fakesource", "--device", "cuda", "--ngulp", "1"]
                      + extra)
    assert exc.value.code == 2
    assert "CUDA devices" in capsys.readouterr().err


#: the operator's FX command line (docs/operations.md), on the fake source
JAX_FX_ARGS = ["--fx", "--adc-dtype", "int8", "--pfb-engine", "pallas",
               "--pfb-precision", "bf16", "--corr-engine", "pallas_blk",
               "--bf-engine", "pallas"]


def test_cli_takes_a_jax_fx_command_line(capsys):
    """``--pfb-engine`` is a name in the port (both values run the one
    channelizer kernel): a JAX FX command line parses in both CLIs to the
    same configuration, and the port's runs it on the CPU."""
    small = ["--fakesource", "--nstand", "8", "--nchan", "32",
             "--nbeam", "4", "--ntime_gulp", "48", "--acc_len", "96",
             "--acc_len_slow", "192"]
    args = pipeline.build_parser().parse_args(small + JAX_FX_ARGS)
    jargs = jcli.build_parser().parse_args(small + JAX_FX_ARGS)
    cfg = pipeline.build_config(args)
    want = C.XEngineConfig(
        nstand=8, nchan=32, nbeam=4, ntime_gulp=48, acc_len=96,
        acc_len_slow=192, pfb_fft_impl=jargs.pfb_impl,
        pfb_engine=jargs.pfb_engine, pfb_precision=jargs.pfb_precision,
        adc_dtype=jargs.adc_dtype, corr_engine=jargs.corr_engine,
        bf_engine=jargs.bf_engine, subsel_engine=cfg.subsel_engine)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert pipeline.main(small + JAX_FX_ARGS + [
        "--device", "cpu", "--ngulp", "4", "-q"]) == 0
    assert "2 fast dumps, 1 slow dumps" in capsys.readouterr().out


@pytest.mark.parametrize("cli", ["pipeline", "bench_fx"])
def test_pfb_engine_pallas_with_fft_exits_2(cli, capsys):
    """``--pfb-engine pallas`` with an FFT channelizer is refused by the
    configuration, as in the JAX package (there a ``ValueError``): the
    port's CLI and FX bench exit 2 naming it."""
    from caltech_bifrost_dsp_tpu_torch.scripts import bench_fx

    jargs = jcli.build_parser().parse_args(
        ["--fx", "--pfb-engine", "pallas", "--pfb-impl", "fft"])
    with pytest.raises(ValueError, match="pfb_engine='pallas'"):
        C.XEngineConfig(pfb_engine=jargs.pfb_engine,
                        pfb_fft_impl=jargs.pfb_impl)
    argv = {"pipeline": ["--fakesource", "--fx", "--pfb-engine", "pallas",
                         "--pfb-impl", "fft", "--device", "cpu"],
            "bench_fx": ["--pfb-engine", "pallas", "--fft-impl", "fft"]}
    main = pipeline.main if cli == "pipeline" else bench_fx.main
    with pytest.raises(SystemExit) as exc:
        main(argv[cli])
    assert exc.value.code == 2
    assert "pfb_engine='pallas'" in capsys.readouterr().err


def _polling(base):
    """A ``fill_into`` source over ``base`` that answers one poll timeout
    (None) at its third call, then real gulps; after ``nreal`` real gulps
    it reports itself stopped (None, ``_stopped``), as a capture does."""

    class Polling(base):
        def __init__(self, cfg, nreal, **kw):
            super().__init__(cfg, mode="random", seed=51, **kw)
            self.nreal = nreal
            self.ncall = 0
            self.nfilled = 0
            self._stopped = False

        def fill_into(self, dest):
            self.ncall += 1
            if self.ncall == 3 or self.nfilled == self.nreal:
                self._stopped = self.nfilled == self.nreal
                return None
            self.nfilled += 1
            return super().fill_into(dest)

        def stream(self, ngulp, seq0=0):
            return super().stream(ngulp, seq0)

    return Polling


@pytest.mark.parametrize("ngulp", ["exact", "until_stopped"])
def test_poll_timeouts_are_skipped_like_jax(ngulp):
    """A None from ``fill_into`` releases its reservation and counts no
    gulp; a stopped source ends the ingest.  Both drivers dump the same
    packets from the same real gulps."""
    cfg = CFG.replace(corr_engine="xla", subsel_engine="xla",
                      bf_engine="xla")
    nreal = 2 * cfg.acc_len_slow // cfg.ntime_gulp
    jsrc = _polling(jsource.DummySource)(cfg, nreal)
    psrc = _polling(source.SyntheticSource)(port_cfg(cfg), nreal)
    (jp, js, jgot), (pp, ps, pgot) = make_pipes(cfg, jsrc, psrc)
    for pipe, store in ((jp, js), (pp, ps)):
        load_gains(pipe, store, cfg, 52)
    n = nreal if ngulp == "exact" else 0
    jp.run(n, timeout_s=300)
    pp.run(n, timeout_s=300)
    assert psrc.nfilled == jsrc.nfilled == nreal
    assert (pp.ndump_fast, pp.ndump_slow) == (jp.ndump_fast, jp.ndump_slow) \
        == (nreal * cfg.ntime_gulp // cfg.acc_len, 2)
    assert_same_packets(jgot, pgot)


def _stalled(base):
    """A source whose ``fill_into`` waits until ``stop()`` (a capture
    with no traffic), then answers None as a stopped capture does."""

    class Stalled(base):
        def __init__(self, cfg):
            super().__init__(cfg)
            self.stopped = threading.Event()
            self._stopped = False

        def fill_into(self, dest):
            self.stopped.wait(timeout=10.0)
            return None

        def stream(self, ngulp, seq0=0):
            return super().stream(ngulp, seq0)

        def stop(self):
            self._stopped = True
            self.stopped.set()

    return Stalled


@pytest.mark.parametrize("driver", ["jax", "port"])
def test_stalled_run_stops_the_source(driver):
    """``run(timeout_s=...)`` on a stalled stream shuts the pipeline down
    and stops its source, so a capture's thread and socket end with it."""
    if driver == "jax":
        src = _stalled(jsource.DummySource)(CFG)
        pipe = JPipe(CFG, src)
    else:
        src = _stalled(source.SyntheticSource)(PCFG)
        pipe = XEnginePipeline(PCFG, src, device="cpu")
    with pytest.raises(TimeoutError):
        pipe.run(4, timeout_s=1.0)
    assert src.stopped.is_set()


def test_stage_error_stops_the_source():
    class Broken(sink.CorrPartOutput):
        def send_subsel(self, *a, **k):
            raise OSError("sink down")

    class Recording(source.SyntheticSource):
        stopped = False

        def stop(self):
            self.stopped = True

    src = Recording(PCFG)
    pp = XEnginePipeline(PCFG, src, device="cpu",
                         subsel_outputs=[Broken(PCFG, send=print)])
    with pytest.raises(RuntimeError, match="stage failed"):
        pp.run(40, timeout_s=120)
    assert src.stopped
