"""The port's ``XEnginePipeline(mesh=2x4)`` against its unsharded run and
against the JAX mesh driver (``tests/test_mesh_driver.py``).

All three run on the CPU over the same synthetic stream, with the same
sinks (packets collected through ``send``) and the same gains commanded
through the control store.  COR and subselection packets must be byte for
byte the same; beam packets are decoded and must be equal (integer gains
make every beam sum exact).  The JAX driver runs over 8 virtual CPU
devices, its Pallas engines in interpret mode.  Also here: the golden
gates on the mesh, and the CLI's ``--mesh``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control.store import MemoryStore as JStore
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.parallel import mesh as jmesh
from caltech_bifrost_dsp_tpu.runtime.driver import XEnginePipeline as JPipe
from caltech_bifrost_dsp_tpu.verification import golden as jgolden
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.scripts import pipeline
from caltech_bifrost_dsp_tpu_torch.utils import proclog
from test_torch_driver import (SYNC, Collect, assert_same_packets,
                               load_gains, sinks)

torch.set_num_threads(1)

# mesh-compatible operating point of tests/test_mesh_driver.py: nchan
# divides the chan axis with nchan_sum-aligned shards; per-(gulp,
# time-shard) spectra divide ntime_sum
JCFG = C.XEngineConfig(nstand=8, nchan=32, ntime_gulp=48, acc_len=96,
                       acc_len_slow=192, nbeam=4, ntime_sum=12, nchan_sum=4,
                       npipeline=2, pfb_ntap=4)
ENGINES = {"xla": dict(corr_engine="xla", bf_engine="xla",
                       subsel_engine="xla"),
           "blk": dict(corr_engine="pallas_blk", bf_engine="pallas",
                       subsel_engine="pallas")}


def port_cfg(jcfg):
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


def cpu_mesh():
    return pm.make_mesh(2, 4, devices=["cpu"] * 8)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def run_port(cfg, src, mesh, ngulp, seed, **kw):
    CommandBlock.reset_instance_counts()
    got, store = Collect(), MemoryStore()
    pipe = XEnginePipeline(cfg, src, store=store, sync_time=SYNC,
                           device="cpu", mesh=mesh,
                           **sinks(sink, cfg, got), **kw)
    load_gains(pipe, store, cfg, seed)
    pipe.run(ngulp, timeout_s=300)
    return pipe, got


def run_jax(jcfg, src, ngulp, seed, **kw):
    got, store = Collect(), JStore()
    pipe = JPipe(jcfg, src, store=store, sync_time=SYNC,
                 mesh=jmesh.make_mesh(2, 4), **sinks(jsink, jcfg, got), **kw)
    load_gains(pipe, store, jcfg, seed)
    pipe.run(ngulp, timeout_s=300)
    return pipe, got


@pytest.mark.parametrize("engines", sorted(ENGINES))
def test_mesh_driver_packets_match_unsharded_and_jax(engines):
    if len(jax.devices()) < 8:
        pytest.skip("need 8 virtual devices")
    jcfg = JCFG.replace(**ENGINES[engines])
    cfg = port_cfg(jcfg)
    ngulp = 3 * cfg.acc_len_slow // cfg.ntime_gulp
    jp, jgot = run_jax(jcfg, jsource.DummySource(jcfg, mode="random",
                                                 seed=11), ngulp, 10)
    mp, mgot = run_port(cfg, source.SyntheticSource(cfg, mode="random",
                                                    seed=11), cpu_mesh(),
                        ngulp, 10)
    up, ugot = run_port(cfg, source.SyntheticSource(cfg, mode="random",
                                                    seed=11), None, ngulp, 10)
    assert (mp.ndump_fast, mp.ndump_slow) == (up.ndump_fast, up.ndump_slow) \
        == (jp.ndump_fast, jp.ndump_slow) == (6, 3)
    assert mgot.cor == ugot.cor and mgot.sub == ugot.sub
    assert mgot.pb == ugot.pb and mgot.ib == ugot.ib
    assert mgot.cor and mgot.sub and mgot.pb and mgot.ib
    assert_same_packets(jgot, mgot)
    powers = np.array([pk.decode_pbeam(p)[1] for p in mgot.pb])
    assert np.abs(powers).sum() > 0


def test_mesh_driver_fx_packets_match_unsharded_and_jax():
    """FX on the mesh: halo between time shards on the mesh, the ADC tail
    carried on the host between blocks."""
    if len(jax.devices()) < 8:
        pytest.skip("need 8 virtual devices")
    jcfg = JCFG.replace(adc_dtype="int8", pfb_fft_impl="matmul",
                        **ENGINES["blk"])
    cfg = port_cfg(jcfg)
    ngulp = 3 * cfg.acc_len_slow // cfg.ntime_gulp
    kw = dict(fx_mode=True, quant_scale=0.1)
    jp, jgot = run_jax(jcfg, jsource.ADCSource(jcfg, amplitude=32.0,
                                               seed=21), ngulp, 22, **kw)
    mp, mgot = run_port(cfg, source.ADCSource(cfg, amplitude=32.0, seed=21),
                        cpu_mesh(), ngulp, 22, **kw)
    up, ugot = run_port(cfg, source.ADCSource(cfg, amplitude=32.0, seed=21),
                        None, ngulp, 22, **kw)
    assert mp.ndump_slow == up.ndump_slow == jp.ndump_slow == 3
    assert mgot.cor == ugot.cor and mgot.sub == ugot.sub
    assert mgot.pb == ugot.pb and mgot.ib == ugot.ib
    assert_same_packets(jgot, mgot)


def test_mesh_driver_per_gulp_mode_equals_batched():
    cfg = port_cfg(JCFG.replace(**ENGINES["blk"]))
    ngulp = 2 * cfg.acc_len_slow // cfg.ntime_gulp
    runs = [run_port(cfg, source.SyntheticSource(cfg, mode="random", seed=5),
                     cpu_mesh(), ngulp, 6, batch_accumulations=batch)[1]
            for batch in (True, False)]
    assert runs[0].cor == runs[1].cor and runs[0].sub == runs[1].sub
    assert runs[0].ib == runs[1].ib
    assert sorted(runs[0].pb) == sorted(runs[1].pb)


def test_mesh_driver_golden_gates(tmp_path):
    """The golden checkfile gate on every slow dump and the numpy
    selftest on every fast dump (the dump call's full matrix), as
    ``tests/test_mesh_driver.py::test_pipeline_on_mesh_golden``."""
    cfg = port_cfg(JCFG)
    ntime = 2 * cfg.acc_len_slow
    inp, corr = str(tmp_path / "in.dat"), str(tmp_path / "corr.dat")
    jgolden.write_input_file(inp, ntime, cfg.nchan, cfg.nstand, cfg.npol,
                             cfg.acc_len)
    jgolden.write_corr_file(corr, ntime, cfg.nchan, cfg.nstand, cfg.npol,
                            cfg.acc_len)
    full = sink.CorrFullOutput(cfg, checkfile=corr,
                               checkfile_acc_len=cfg.acc_len)
    sub = []
    pipe = XEnginePipeline(
        cfg, source.SyntheticSource(cfg, mode="testfile", testfile=inp),
        corr_outputs=[full],
        subsel_outputs=[sink.CorrPartOutput(cfg, send=sub.append)],
        device="cpu", mesh=cpu_mesh(), selftest=True)
    pipe.run(ntime // cfg.ntime_gulp, timeout_s=300)
    assert pipe.ndump_fast == ntime // cfg.acc_len and pipe.ndump_slow == 2
    assert full.check_count == 2 and full.check_failures == 0
    assert pipe.selftest_count == pipe.ndump_fast
    assert pipe.selftest_failures == 0
    assert sub


def test_mesh_driver_refuses_a_mesh_on_another_device_type():
    cfg = port_cfg(JCFG)
    with pytest.raises(ValueError, match="mesh lies on"):
        XEnginePipeline(cfg, source.SyntheticSource(cfg), device="cuda",
                        mesh=cpu_mesh())
    with pytest.raises(ValueError, match="nchan_sum"):
        XEnginePipeline(port_cfg(C.TINY.replace(nchan=24)),
                        source.SyntheticSource(cfg), device="cpu",
                        mesh=cpu_mesh())


CLI = ["--fakesource", "--nstand", "16", "--nchan", "16", "--nbeam", "4",
       "--ntime_gulp", "48", "--acc_len", "240", "--acc_len_slow", "480",
       "--ngulp", "20", "-q"]


def test_cli_mesh_on_the_cpu_returns_0(capsys):
    assert pipeline.main(CLI + ["--mesh", "2x4", "--device", "cpu",
                                "--testcorr"]) == 0
    out = capsys.readouterr().out
    assert "4 fast dumps, 2 slow dumps" in out and "selftest: 4/4" in out


def test_cli_mesh_fx_tone_on_the_cpu(tmp_path):
    slow = str(tmp_path / "slow.npz")
    rc = pipeline.main([
        "--fakesource", "--fx", "--fx-tone-chan", "9", "--nstand", "8",
        "--nchan", "32", "--ntime_gulp", "48", "--acc_len", "96",
        "--acc_len_slow", "192", "--nbeam", "4", "--ngulp", "8", "--device",
        "cpu", "--mesh", "2x4", "--save-slow", slow, "-q"])
    assert rc == 0
    assert int(np.load(slow)["real"][:, 0, 0].argmax()) == 9


@pytest.mark.parametrize("mesh,msg", [("2x4", "CUDA devices"),
                                      ("twoxfour", "TIMExCHAN")])
def test_cli_mesh_without_the_devices_exits_2(mesh, msg, capsys):
    if torch.cuda.device_count() >= 8:
        pytest.skip("8 CUDA devices are present")
    with pytest.raises(SystemExit) as exc:
        pipeline.main(CLI + ["--mesh", mesh, "--device", "cuda"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert msg in err
    if mesh == "2x4":
        assert f"has {torch.cuda.device_count()}" in err
