"""The port's FX path vs the JAX package: ``fx_step`` against
``fx_step_jit`` over a full fast+slow flag cycle, the runner in FX mode
against the JAX driver's semantics, ``ADCSource`` byte for byte, and the
CLI's FX flags.

Gates: packed channelizer bytes through ``assert_packed_close``; fast,
slow and subselection exact int32; beam power and VLBI rtol 1e-4 with
atol 1e-4 * max|ref|.  JAX runs its TPU engines (Pallas in interpret
mode, the matmul channelizer) and its XLA engines (the rfft channelizer).

The JAX Pallas channelizer's "high" precision is the bf16_3x split, whose
error of ~1e-5 of a code moves values that close to a rounding threshold
to the other code: about 1.5e-5 of the values at CPU_REF, every one a
tolerated threshold case of the gate.  So each step of the flag cycle
holds (a) the bytes under the gate, (b) the port's X/B products exactly
against the JAX step on the port's bytes, and (c) the whole JAX
``fx_step_jit`` exactly wherever the bytes are identical.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.models import xengine as jx
from caltech_bifrost_dsp_tpu.ops import pfb as jpfb
from caltech_bifrost_dsp_tpu.ops.beamform import BeamGains as JGains
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.io import source as psource
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
from caltech_bifrost_dsp_tpu_torch.ops import pfb
from caltech_bifrost_dsp_tpu_torch.runtime.runner import (XEngineRunner,
                                                          fx_scale)
from caltech_bifrost_dsp_tpu_torch.scripts import pipeline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"tiny": C.TINY.replace(pfb_ntap=4),
           "cpu_ref": C.CPU_REF.replace(pfb_ntap=4),
           "ragged": C.TINY.replace(nstand=36, nchan=8, pfb_ntap=4)}
ENGINES = {"tpu": dict(C.TPU_ENGINES, pfb_engine="pallas",
                       pfb_fft_impl="matmul"),
           "xla": dict(corr_engine="xla", bf_engine="xla",
                       subsel_engine="xla", pfb_fft_impl="fft")}
T, F = True, False
CYCLE = [(T, F, F), (F, F, F), (F, T, T), (T, T, F), (T, F, F), (F, T, F),
         (T, T, T)]
# a small config for the runner: two gulps per fast window, two fast
# windows per slow window
RCFG = C.XEngineConfig(nstand=8, nchan=16, ntime_gulp=48, acc_len=96,
                       acc_len_slow=192, nbeam=2, ntime_sum=12, nchan_sum=4,
                       pfb_ntap=4, adc_dtype="int8")


def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


#: the runner's config on the port's side
PRCFG = port_cfg(RCFG)


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def make_adc(rng, cfg, dtype, ntime):
    shape = ((ntime + cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput)
    if dtype == "int8":
        return rng.randint(-90, 91, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 20).astype(np.float32)


def rms_scale(adc, cfg):
    """A requant gain that puts the pre-quantization rms near 2.5 codes."""
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    re, _ = pfb.pfb_prequant_ref(torch.from_numpy(adc), w, cfg.nchan,
                                 cfg.pfb_ntap, 1.0)
    return np.float32(2.5 / float(re.std()))


def jax_packed(adc, w, jcfg, scale):
    """The JAX channelizer's bytes, input-major, for either transform."""
    if jcfg.pfb_fft_impl == "matmul":
        return np.asarray(jpfb.channelize_pack_imajor(
            jnp.asarray(adc), jnp.asarray(w), jcfg, jnp.float32(scale)))
    spec = jpfb.pfb_channelize(jnp.asarray(adc), jnp.asarray(w), jcfg.nchan,
                               jcfg.pfb_ntap, fft_impl="fft")
    return np.asarray(jpfb.quantize_4bit(spec, jnp.float32(scale))) \
        .transpose(2, 0, 1)


def check_packed(adc, w, cfg, jcfg, scale):
    """Port bytes (input-major) under the gate; returns them and the count
    of tolerated threshold cases."""
    xt = torch.from_numpy(adc)
    got = pfb.channelize_pack_imajor(xt, w, cfg, scale)
    pre = pfb.pfb_prequant_ref(xt, w, cfg.nchan, cfg.pfb_ntap, scale)
    want = torch.from_numpy(jax_packed(adc, w, jcfg, scale).copy())
    return got, pfb.assert_packed_close(got, want, pre)


def assert_vis_equal(jvis, jcfg, pvis, cfg):
    want = jx.dense_vis(jvis, jcfg)
    got = px.dense_vis(pvis, cfg)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))


def gains_pairs(cfg, seed):
    rng = np.random.RandomState(seed)
    gr = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    gi = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    _, _, _, pairs = px.default_inputs(cfg)
    return gr, gi, pairs.numpy()


@pytest.mark.parametrize("dtype", ["int8", "float32"])
@pytest.mark.parametrize("engines", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fx_cycle_matches_jax(name, engines, dtype):
    base = CONFIGS[name].replace(adc_dtype=dtype)
    jcfg, cfg = base.replace(**ENGINES[engines]), port_cfg(base)
    rng = np.random.RandomState(11)
    gr, gi, pairs = gains_pairs(cfg, 12)
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    blocks = [make_adc(rng, cfg, dtype, cfg.ntime_gulp) for _ in CYCLE]
    scale = rms_scale(blocks[0], cfg)
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    pg = px.gains_from_numpy(gr, gi)
    jstate, pstate = jx.init_state(jcfg), px.init_state(cfg)
    nval = tolerated = 0
    for adc, flags in zip(blocks, CYCLE):
        packed, n = check_packed(adc, w, cfg, jcfg, scale)
        nval += 2 * packed.numel()
        tolerated += n
        jfx_state, jfx = jx.fx_step_jit(
            jstate, jnp.asarray(adc), jnp.asarray(w), jnp.float32(scale), jg,
            jnp.asarray(pairs), *flags, jcfg)
        jstate, jo = jx.xengine_step_jit(
            jstate, jnp.asarray(packed.permute(1, 2, 0).numpy()), jg,
            jnp.asarray(pairs), *flags, jcfg)
        pstate, po = px.fx_step(pstate, torch.from_numpy(adc),
                                torch.from_numpy(w), scale, pg,
                                torch.from_numpy(pairs), *flags, cfg)
        wants = [(jstate, jo)] + ([(jfx_state, jfx)] if n == 0 else [])
        for js, out in wants:
            assert_vis_equal(js.vis_fast, jcfg, pstate.vis_fast, cfg)
            assert_vis_equal(js.vis_slow, jcfg, pstate.vis_slow, cfg)
            if flags[1]:
                np.testing.assert_array_equal(po.subsel.real.numpy(),
                                              np.asarray(out.subsel.real))
                np.testing.assert_array_equal(po.subsel.imag.numpy(),
                                              np.asarray(out.subsel.imag))
            close(po.bf_power, out.bf_power)
            close(po.vlbi, out.vlbi)
    if engines == "xla":
        assert tolerated == 0
    assert tolerated <= 1e-4 * nval


def test_fx_cti_layout_and_per_channel_scale_match_jax():
    base = CONFIGS["ragged"].replace(adc_dtype="int8")
    jcfg, cfg = base.replace(**ENGINES["tpu"]), port_cfg(base)
    rng = np.random.RandomState(13)
    gr, gi, pairs = gains_pairs(cfg, 14)
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    adc = make_adc(rng, cfg, "int8", cfg.ntime_gulp)
    scale = (rms_scale(adc, cfg)
             * rng.uniform(0.7, 1.3, cfg.nchan)).astype(np.float32)
    assert check_packed(adc, w, cfg, jcfg, scale)[1] == 0
    jstate, jo = jx.fx_step_jit(
        jx.init_state(jcfg), jnp.asarray(adc), jnp.asarray(w),
        jnp.asarray(scale), JGains(jnp.asarray(gr), jnp.asarray(gi)),
        jnp.asarray(pairs), T, T, T, jcfg, layout="cti")
    pstate, po = px.fx_step(
        px.init_state(cfg), torch.from_numpy(adc), torch.from_numpy(w),
        torch.from_numpy(scale), px.gains_from_numpy(gr, gi),
        torch.from_numpy(pairs), T, T, T, cfg, layout="cti")
    assert_vis_equal(jstate.vis_slow, jcfg, pstate.vis_slow, cfg)
    np.testing.assert_array_equal(po.subsel.real.numpy(),
                                  np.asarray(jo.subsel.real))
    close(po.bf_power, jo.bf_power)
    close(po.vlbi, jo.vlbi)
    with pytest.raises(ValueError):
        px.fx_step(pstate, torch.from_numpy(adc), torch.from_numpy(w), 1.0,
                   px.gains_from_numpy(gr, gi), torch.from_numpy(pairs),
                   T, T, T, cfg, layout="ict")


@pytest.mark.parametrize("mode", ["noise", "tone"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_adc_source_matches_jax(mode, dtype):
    jcfg = RCFG.replace(adc_dtype=dtype)
    cfg = port_cfg(jcfg)
    amp = 32.0 if dtype == "int8" else 4.0
    js = jsource.ADCSource(jcfg, mode=mode, tone_chan=3, amplitude=amp)
    ps = psource.ADCSource(cfg, mode=mode, tone_chan=3, amplitude=amp)
    for (jt, jg), (pt, pg) in zip(js.stream(3, seq0=96),
                                  ps.stream(3, seq0=96)):
        assert jt == pt
        assert pg.dtype == jg.dtype and pg.shape == jg.shape
        np.testing.assert_array_equal(pg, jg)
    with pytest.raises(ValueError):
        psource.ADCSource(cfg, mode="ramp")


def _gulps(cfg, n, seed=21):
    src = psource.ADCSource(cfg, mode="noise", amplitude=40.0, seed=seed)
    return [(i * cfg.ntime_gulp, src.gulp(i)) for i in range(n)]


def test_runner_fx_whole_window_equals_per_gulp():
    """One call per window with the FIR history staged in front equals
    per-gulp fx_step calls that carry the history themselves (the
    runner's per-gulp fallback)."""
    cfg = PRCFG
    gulps = _gulps(cfg, 8)
    runner = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1)
    whole = list(runner.run(iter(gulps)))
    assert len(whole) == 4 and runner.ndump_slow == 2
    w = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap))
    state = px.init_state(cfg)
    tail = np.zeros((3 * 2 * cfg.nchan, cfg.ninput), np.int8)
    for k, prod in enumerate(whole):
        outs = []
        for j, (_, gulp) in enumerate(gulps[2 * k:2 * k + 2]):
            block = np.concatenate([tail, gulp])
            tail = gulp[len(gulp) - len(tail):]
            state, out = px.fx_step(
                state, torch.from_numpy(block), w, 0.1, runner.gains,
                runner.subsel_pairs, j == 0, j == 1, k % 2 == 0, cfg)
            outs.append(out)
        np.testing.assert_array_equal(prod["subsel"][0],
                                      outs[1].subsel.real.numpy())
        np.testing.assert_array_equal(prod["subsel"][1],
                                      outs[1].subsel.imag.numpy())
        close(prod["vlbi"], torch.cat([o.vlbi for o in outs]))
        close(prod["bf_power"], torch.cat([o.bf_power for o in outs], 1))
        if "vis_slow" in prod:
            dense = px.dense_vis(state.vis_slow, cfg)
            np.testing.assert_array_equal(prod["vis_slow"][0],
                                          dense.real.numpy())
            np.testing.assert_array_equal(prod["vis_slow"][1],
                                          dense.imag.numpy())
    np.testing.assert_array_equal(runner.adc_tail, tail)


def test_runner_fx_matches_jax_stream():
    """Whole-window calls with the carried FIR history equal JAX
    ``fx_step_jit`` fed the driver's ``concat(tail, block)``."""
    cfg = PRCFG
    jcfg = RCFG.replace(pfb_fft_impl="matmul")
    gulps = _gulps(cfg, 8, seed=22)
    gr, gi, pairs = gains_pairs(cfg, 23)
    runner = XEngineRunner(cfg, "cpu", gains=px.gains_from_numpy(gr, gi),
                           subsel_pairs=pairs, fx=True, quant_scale=0.1)
    w = jnp.asarray(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap))
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    jstate = jx.init_state(jcfg)
    tail = np.zeros(((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput),
                    np.int8)
    gpw = cfg.acc_len // cfg.ntime_gulp
    for k, prod in enumerate(runner.run(iter(gulps))):
        block = np.concatenate([g for _, g in gulps[k * gpw:(k + 1) * gpw]])
        jstate, jo = jx.fx_step_jit(
            jstate, jnp.asarray(np.concatenate([tail, block])), w,
            jnp.float32(0.1), jg, jnp.asarray(pairs), T, T, k % 2 == 0,
            jcfg)
        tail = block[len(block) - len(tail):]
        np.testing.assert_array_equal(prod["subsel"][0],
                                      np.asarray(jo.subsel.real))
        np.testing.assert_array_equal(prod["subsel"][1],
                                      np.asarray(jo.subsel.imag))
        close(prod["bf_power"], jo.bf_power)
        close(prod["vlbi"], jo.vlbi)
        if "vis_slow" in prod:
            want = jx.dense_vis(jstate.vis_slow, jcfg)
            np.testing.assert_array_equal(prod["vis_slow"][0],
                                          np.asarray(want.real))
            np.testing.assert_array_equal(prod["vis_slow"][1],
                                          np.asarray(want.imag))
    assert runner.ndump_slow == 2


def test_runner_fx_history_resets_on_new_sequence():
    """After a sequence break the FIR history restarts at zero (the JAX
    driver's test_fx_tail_resets_on_sequence_break): products after the
    break equal a fresh runner's on the same gulps."""
    cfg = PRCFG
    g = cfg.ntime_gulp
    gulps = _gulps(cfg, 10, seed=24)
    tails = []
    runner = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1)
    orig = runner._upload

    def spy(gs):
        tails.append(runner.adc_tail.copy())
        return orig(gs)

    runner._upload = spy
    first = list(runner.run(iter(gulps[:4])))
    gap = 10_000 * g
    runner.new_sequence(gap)
    assert not np.any(runner.adc_tail)
    recover = (gap // cfg.acc_len + 10) * cfg.acc_len
    after = [(recover + i * g, x) for i, (_, x) in enumerate(gulps[4:8])]
    second = list(runner.run(iter(after)))
    assert len(first) == 2 and len(second) == 2
    assert not np.any(tails[0]) and np.any(tails[1])
    assert not np.any(tails[2]) and np.any(tails[3])
    fresh = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1,
                          autostartat=recover)
    for a, b in zip(second, fresh.run(iter(after))):
        np.testing.assert_array_equal(a["vlbi"], b["vlbi"])
        if "subsel" in a:
            np.testing.assert_array_equal(a["subsel"][0], b["subsel"][0])


def test_runner_fx_single_tap_history_stays_empty():
    cfg = PRCFG.replace(pfb_ntap=1)
    runner = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1)
    assert runner.adc_tail.shape == (0, cfg.ninput)
    list(runner.run(iter(_gulps(cfg, 2))))
    assert runner.adc_tail.shape == (0, cfg.ninput)
    assert runner.ndump_fast == 1
    with pytest.raises(ValueError, match="adc_tail"):
        XEngineRunner(PRCFG, "cpu", fx=True,
                      adc_tail=np.zeros((5, RCFG.ninput), np.int8))


def test_runner_fx_eq_gains_equal_per_channel_scale():
    """eq_gains * quant_scale (float32, as the JAX FEngine block forms
    it) gives the same products as passing that vector to fx_step."""
    cfg = PRCFG
    eq = np.random.RandomState(25).uniform(0.5, 2.0, cfg.nchan).tolist()
    vec = np.asarray(eq, np.float32) * np.float32(0.1)
    np.testing.assert_array_equal(fx_scale(0.1, eq), vec)
    assert fx_scale(0.1).shape == () and fx_scale(0.1, []).shape == ()
    gulps = _gulps(cfg, 2, seed=26)
    runner = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1, eq_gains=eq)
    prod = next(runner.run(iter(gulps)))
    block = np.concatenate([np.zeros((3 * 2 * cfg.nchan, cfg.ninput),
                                     np.int8)] + [x for _, x in gulps])
    w = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap))
    _, want = px.fx_step(px.init_state(cfg), torch.from_numpy(block), w,
                         torch.from_numpy(vec), runner.gains,
                         runner.subsel_pairs, T, T, T, cfg)
    np.testing.assert_array_equal(prod["vlbi"], want.vlbi.numpy())
    np.testing.assert_array_equal(prod["subsel"][0], want.subsel.real.numpy())


def test_runner_starts_from_jax_tail():
    """A JAX driver's ``_adc_tail`` starts the port's runner at the same
    point: equal to running the previous gulps through the runner."""
    cfg = PRCFG
    gulps = _gulps(cfg, 4, seed=27)
    full = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1)
    prods = list(full.run(iter(gulps)))
    prev = gulps[1][1]
    tail = prev[len(prev) - 3 * 2 * cfg.nchan:]
    resumed = XEngineRunner(cfg, "cpu", fx=True, quant_scale=0.1,
                            adc_tail=tail, autostartat=2 * cfg.ntime_gulp)
    (prod,) = list(resumed.run(iter(gulps[2:])))
    np.testing.assert_array_equal(prod["vlbi"], prods[1]["vlbi"])
    np.testing.assert_array_equal(prod["subsel"][0], prods[1]["subsel"][0])


def test_cli_fx_tone_lands_in_channel(tmp_path):
    """``--fx --fx-tone-chan 9 --device cpu``: the assertions of
    tests/test_fx_driver.py::test_fx_pipeline_tone_lands_in_channel."""
    out = tmp_path / "slow.npz"
    rc = pipeline.main(["--fakesource", "--fx", "--fx-tone-chan", "9",
                        "--adc-amplitude", "5.0", "--nstand", "8",
                        "--nchan", "32", "--ntime_gulp", "48",
                        "--acc_len", "96", "--acc_len_slow", "192",
                        "--nbeam", "4", "--ngulp", "8", "--device", "cpu",
                        "--save-slow", str(out)])
    assert rc == 0
    d = np.load(out)
    vis = d["real"] + 1j * d["imag"]
    autos = np.real(vis[:, 0, 0])
    assert autos.argmax() == 9
    others = np.delete(autos, [8, 9, 10])
    assert others.max() < 0.05 * autos[9]
    assert np.allclose(np.real(vis[9]), autos[9], rtol=0.01)


def test_cli_fx_refuses_golden_vectors():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "caltech_bifrost_dsp_tpu_torch.scripts.pipeline",
         "--fakesource", "--fx", "--testdatain", "in.dat", "--device", "cpu",
         "--ngulp", "1"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert "--fx" in proc.stderr


def test_cli_fx_eq_gains_file(tmp_path):
    """--eq-gains reads nchan positive floats from a text or .npy file and
    refuses any other count."""
    gains = np.linspace(0.5, 1.5, 32)
    np.savetxt(tmp_path / "eq.txt", gains)
    np.save(tmp_path / "eq.npy", gains)
    for name in ("eq.txt", "eq.npy"):
        assert pipeline.load_eq_gains(str(tmp_path / name), 32) == \
            pytest.approx(gains.tolist())
    assert pipeline.load_eq_gains(None, 32) is None
    with pytest.raises(ValueError, match="16 positive"):
        pipeline.load_eq_gains(str(tmp_path / "eq.txt"), 16)
    rc = pipeline.main(["--fakesource", "--fx", "--nstand", "8",
                        "--nchan", "32", "--ntime_gulp", "48",
                        "--acc_len", "96", "--acc_len_slow", "192",
                        "--nbeam", "4", "--ngulp", "2", "--device", "cpu",
                        "--adc-dtype", "int8", "--quant-scale", "0.05",
                        "--eq-gains", str(tmp_path / "eq.npy")])
    assert rc == 0
