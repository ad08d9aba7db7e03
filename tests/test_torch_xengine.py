"""The port's fused step vs the JAX ``xengine_step`` over a full fast+slow
cycle: exact int32 for the fast and slow accumulators (through
``dense_vis``) and subselection; rtol 1e-4 with atol 1e-4 * max|ref| for
beam power and VLBI.  JAX runs its committed TPU engines (Pallas in
interpret mode on the CPU) and its XLA engines."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.models import xengine as jx
from caltech_bifrost_dsp_tpu.ops.beamform import BeamGains as JGains
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.models import xengine as px

torch.set_num_threads(1)

CONFIGS = {"tiny": C.TINY, "cpu_ref": C.CPU_REF,
           "ragged": C.TINY.replace(nstand=36, nchan=8)}
ENGINES = {"tpu": C.TPU_ENGINES,
           "xla": dict(corr_engine="xla", bf_engine="xla",
                       subsel_engine="xla")}
T, F = True, False
# three fast windows of 3, 1 and 2 calls, then a fresh slow window:
# every distinct (fast_first, fast_last, slow_first) combination
CYCLE = [(T, F, F), (F, F, F), (F, T, T), (T, T, F), (T, F, F), (F, T, F),
         (T, T, T)]
MALFORMED = [[800, 3], [3, 800], [-1, 4], [900, 900]]


def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def assert_vis_equal(jvis, jcfg, pvis, cfg):
    want = jx.dense_vis(jvis, jcfg)
    got = px.dense_vis(pvis, cfg)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))


def make_inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    gr = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    gi = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    _, _, _, pairs = px.default_inputs(cfg)
    pairs = np.concatenate([pairs.numpy(), MALFORMED]).astype(np.int32)
    gulps = [rng.randint(0, 256, (cfg.ntime_gulp, cfg.nchan, cfg.ninput))
             .astype(np.uint8) for _ in CYCLE]
    return gr, gi, pairs, gulps


def run_both(cfg, jcfg, jstate, pstate, gr, gi, pairs, gulps, flags_seq):
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    pg = px.gains_from_numpy(gr, gi)
    for gulp, flags in zip(gulps, flags_seq):
        jstate, jo = jx.xengine_step_jit(jstate, jnp.asarray(gulp), jg,
                                         jnp.asarray(pairs), *flags, jcfg)
        pstate, po = px.xengine_step(pstate, torch.from_numpy(gulp), pg,
                                     torch.from_numpy(pairs), *flags, cfg)
        assert_vis_equal(jstate.vis_fast, jcfg, pstate.vis_fast, cfg)
        assert_vis_equal(jstate.vis_slow, jcfg, pstate.vis_slow, cfg)
        if flags[1]:
            np.testing.assert_array_equal(po.subsel.real.numpy(),
                                          np.asarray(jo.subsel.real))
            np.testing.assert_array_equal(po.subsel.imag.numpy(),
                                          np.asarray(jo.subsel.imag))
        else:
            assert po.subsel is None
        close(po.bf_power, jo.bf_power)
        close(po.vlbi, jo.vlbi)
    return jstate, pstate


@pytest.mark.parametrize("engines", sorted(ENGINES))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_cycle_matches_jax(name, engines):
    jcfg = CONFIGS[name].replace(**ENGINES[engines])
    cfg = port_cfg(jcfg)
    gr, gi, pairs, gulps = make_inputs(cfg, 1)
    run_both(cfg, jcfg, jx.init_state(jcfg), px.init_state(cfg), gr, gi,
             pairs, gulps, CYCLE)


def test_state_from_numpy_continues_jax_state():
    """Run JAX (padded block-engine state) for one fast window, carry its
    state into the port, and continue both."""
    jcfg = CONFIGS["ragged"].replace(**C.TPU_ENGINES)
    cfg = port_cfg(jcfg)
    gr, gi, pairs, gulps = make_inputs(cfg, 2)
    jstate, _ = run_both(cfg, jcfg, jx.init_state(jcfg), px.init_state(cfg),
                         gr, gi, pairs, gulps[:3], CYCLE[:3])
    assert jstate.vis_fast.real.shape[1] == 256     # padded JAX width
    pstate = px.state_from_numpy(jax.device_get(jstate), cfg)
    assert pstate.vis_fast.real.shape == (cfg.nchan, cfg.ninput, cfg.ninput)
    run_both(cfg, jcfg, jstate, pstate, gr, gi, pairs, gulps[3:], CYCLE[3:])


def test_cti_layout_matches_jax():
    jcfg = CONFIGS["ragged"].replace(**C.TPU_ENGINES)
    cfg = port_cfg(jcfg)
    gr, gi, pairs, gulps = make_inputs(cfg, 3)
    staged = np.full((cfg.nchan, cfg.ntime_gulp, 256), 0xC3, np.uint8)
    staged[:, :, :cfg.ninput] = gulps[0].transpose(1, 0, 2)
    jstate, jo = jx.xengine_step_jit(
        jx.init_state(jcfg), jnp.asarray(staged),
        JGains(jnp.asarray(gr), jnp.asarray(gi)), jnp.asarray(pairs),
        T, T, T, jcfg, layout="cti")
    pstate, po = px.xengine_step(
        px.init_state(cfg), torch.from_numpy(staged),
        px.gains_from_numpy(gr, gi), torch.from_numpy(pairs), T, T, T, cfg,
        layout="cti")
    assert_vis_equal(jstate.vis_slow, jcfg, pstate.vis_slow, cfg)
    np.testing.assert_array_equal(po.subsel.real.numpy(),
                                  np.asarray(jo.subsel.real))
    close(po.bf_power, jo.bf_power)
    close(po.vlbi, jo.vlbi)


def test_want_flags_skip_products():
    cfg = port_cfg(CONFIGS["tiny"])
    state, packed, gains, pairs = px.default_inputs(cfg)
    _, out = px.xengine_step(state, packed, gains, pairs, T, T, T, cfg,
                             want_power=False, want_vlbi=False,
                             want_subsel=False)
    assert out == px.XEngineOutputs(None, None, None)
    with pytest.raises(ValueError):
        px.xengine_step(state, packed, gains, pairs, T, T, T, cfg,
                        layout="ict")


def test_default_inputs_match_jax():
    jcfg = CONFIGS["cpu_ref"]
    _, jpacked, jgains, jpairs = jx.default_inputs(jcfg, seed=4)
    _, packed, gains, pairs = px.default_inputs(port_cfg(jcfg), seed=4)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(jpairs))
    np.testing.assert_array_equal(gains.real.numpy(), np.asarray(jgains.real))
