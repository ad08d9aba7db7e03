"""The ``pallas_triu`` / ``pallas`` engines of the port against JAX.

- ``ops/corr_triu.py::corr_triu`` (its plain version on the CPU) against
  ``ops/pallas/corr_triu.py::packed_corr_triu`` in interpret mode: exact
  int32 on every entry of the 128-input tiles with tile(j) >= tile(i).
- ``corr_subsel_engine`` for every engine name against the JAX dispatch
  (the Pallas lane gather in interpret mode): exact.
- the port's ``xengine_step`` with ``corr_engine="pallas_triu"`` and
  ``subsel_engine="pallas"`` against ``xengine_step_jit`` over the flag
  cycle: exact on j >= i, after ``dense_vis``, and for the subselection;
  beam products within rtol 1e-4 (atol 1e-4 * max|ref|).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.models import xengine as jx
from caltech_bifrost_dsp_tpu.ops import corr_subsel as jcs
from caltech_bifrost_dsp_tpu.ops.beamform import BeamGains as JGains
from caltech_bifrost_dsp_tpu.ops.correlate import Vis as JVis
from caltech_bifrost_dsp_tpu.ops.pallas.corr_triu import packed_corr_triu
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops.corr_triu import (TILE, corr_triu,
                                                         corr_triu_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import Vis, chan_major

torch.set_num_threads(1)

TRIU = dict(corr_engine="pallas_triu", subsel_engine="pallas",
            bf_engine="pallas")
CONFIGS = {"tiny": C.TINY, "cpu_ref": C.CPU_REF,
           "ragged": C.TINY.replace(nstand=68, nchan=8)}
T, F = True, False
CYCLE = [(T, F, F), (F, F, F), (F, T, T), (T, T, F), (T, F, F), (F, T, F),
         (T, T, T)]
MALFORMED = [[800, 3], [3, 800], [-1, 4], [900, 900]]


def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


def upper_tiles(ni):
    tile = np.arange(ni) // TILE
    return tile[:, None] <= tile[None, :]


@pytest.mark.parametrize("ntime,nchan,ni", [(48, 4, 32), (37, 3, 136),
                                            (16, 2, 260)])
def test_corr_triu_matches_packed_corr_triu(ntime, nchan, ni):
    rng = np.random.RandomState(ni)
    packed = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
    want = packed_corr_triu(jnp.asarray(packed), interpret=True)
    got = corr_triu(torch.from_numpy(packed))
    m = upper_tiles(ni)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:, m], np.asarray(w)[:, m])


def test_corr_triu_cti_layout_ignores_pad_lanes():
    rng = np.random.RandomState(2)
    ni, pad = 70, 10
    packed = rng.randint(0, 256, (24, 3, ni)).astype(np.uint8)
    staged = np.full((3, 24, ni + pad), 0xA5, np.uint8)
    staged[:, :, :ni] = packed.transpose(1, 0, 2)
    got = corr_triu(torch.from_numpy(staged), "cti", ni)
    want = corr_triu_ref(chan_major(torch.from_numpy(packed), "tci"))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        corr_triu(torch.from_numpy(staged), "ict")


@pytest.mark.parametrize("engine", cs.SUBSEL_ENGINES)
def test_subsel_engines_match_jax(engine):
    cfg = C.CPU_REF
    rng = np.random.RandomState(3)
    n = cfg.ninput
    vr = rng.randint(-2 ** 20, 2 ** 20, (cfg.nchan, n, n)).astype(np.int32)
    vi = rng.randint(-2 ** 20, 2 ** 20, (cfg.nchan, n, n)).astype(np.int32)
    pairs = rng.randint(0, n, (cfg.nvis_out, 2)).astype(np.int32)
    want = jcs.corr_subsel_engine(JVis(jnp.asarray(vr), jnp.asarray(vi)),
                                  jnp.asarray(pairs), cfg.nchan_sum, engine,
                                  interpret=True)
    got = cs.corr_subsel_engine(Vis(torch.from_numpy(vr),
                                    torch.from_numpy(vi)),
                                torch.from_numpy(pairs), cfg.nchan_sum,
                                engine)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))
    with pytest.raises(ValueError, match="unknown"):
        cs.corr_subsel_engine(got, torch.from_numpy(pairs), 1, "take")


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def assert_state_equal(jvis, jcfg, pvis, cfg):
    m = upper_tiles(cfg.ninput)
    for g, w in zip(pvis, jvis):
        np.testing.assert_array_equal(g.numpy()[:, m], np.asarray(w)[:, m])
    want = jx.dense_vis(jvis, jcfg)
    got = px.dense_vis(pvis, cfg)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_triu_step_matches_jax_over_the_flag_cycle(name):
    jcfg = CONFIGS[name].replace(**TRIU)
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(4)
    gr = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    gi = rng.randn(cfg.nchan, cfg.nbeam, cfg.ninput).astype(np.float32)
    _, _, _, pairs = px.default_inputs(cfg)
    pairs = np.concatenate([pairs.numpy(), MALFORMED]).astype(np.int32)
    jstate, pstate = jx.init_state(jcfg), px.init_state(cfg)
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    pg = px.gains_from_numpy(gr, gi)
    for flags in CYCLE:
        gulp = rng.randint(0, 256, (cfg.ntime_gulp, cfg.nchan, cfg.ninput)) \
            .astype(np.uint8)
        jstate, jo = jx.xengine_step_jit(jstate, jnp.asarray(gulp), jg,
                                         jnp.asarray(pairs), *flags, jcfg)
        pstate, po = px.xengine_step(pstate, torch.from_numpy(gulp), pg,
                                     torch.from_numpy(pairs), *flags, cfg)
        assert_state_equal(jstate.vis_fast, jcfg, pstate.vis_fast, cfg)
        assert_state_equal(jstate.vis_slow, jcfg, pstate.vis_slow, cfg)
        if flags[1]:
            np.testing.assert_array_equal(po.subsel.real.numpy(),
                                          np.asarray(jo.subsel.real))
            np.testing.assert_array_equal(po.subsel.imag.numpy(),
                                          np.asarray(jo.subsel.imag))
        else:
            assert po.subsel is None and jo.subsel is None
        close(po.bf_power, jo.bf_power)
        close(po.vlbi, jo.vlbi)


def test_triu_step_cti_matches_tci():
    cfg = port_cfg(C.TINY.replace(nstand=36, nchan=8, **TRIU))
    state_a, packed, gains, pairs = px.default_inputs(cfg, seed=5)
    state_b = px.init_state(cfg)
    staged = torch.full((cfg.nchan, cfg.ntime_gulp, 128), 0x5A,
                        dtype=torch.uint8)
    staged[:, :, :cfg.ninput] = packed.permute(1, 0, 2)
    _, a = px.xengine_step(state_a, packed, gains, pairs, T, T, T, cfg)
    _, b = px.xengine_step(state_b, staged, gains, pairs, T, T, T, cfg,
                           layout="cti")
    for x, y in zip((*state_a.vis_slow, *a.subsel),
                    (*state_b.vis_slow, *b.subsel)):
        assert torch.equal(x, y)
