"""The port's sharded programs (``parallel/mesh.py``) against the JAX ones.

The same numpy inputs, made from a seed, go through the JAX programs on
``pmesh.make_mesh(2, 4)`` (8 virtual CPU devices; Pallas engines in
interpret mode, as ``tests/test_parallel.py`` runs them) and through the
port on ``make_mesh(2, 4, devices=["cpu"] * 8)``, and through the port's
unsharded step.  Tolerances: visibilities, subselection and accumulator
state exact; beam power and VLBI within rtol 1e-4 (atol 1e-4 x max|want|).
The FX programs are compared with JAX through the packed-byte gate of
``tests/test_torch_fx.py``: where the float32 JAX channelizer and the
float64 plain version put no code on different sides of a rounding
threshold (the gate counts such cases), the integers must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.models import xengine as jx
from caltech_bifrost_dsp_tpu.ops import pfb as jpfb
from caltech_bifrost_dsp_tpu.ops.beamform import BeamGains as JGains
from caltech_bifrost_dsp_tpu.parallel import mesh as jmesh
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
from caltech_bifrost_dsp_tpu_torch.ops import pfb
from caltech_bifrost_dsp_tpu_torch.ops.correlate import correlate_gulp
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

# nchan=32 keeps every chan-shard count's channels a multiple of nchan_sum
JCFG = C.XEngineConfig(nstand=8, nchan=32, ntime_gulp=48, acc_len=96,
                       acc_len_slow=192, nbeam=4, ntime_sum=12, nchan_sum=4,
                       npipeline=2, pfb_ntap=4, pfb_fft_impl="matmul")
ENGINES = {"xla": dict(corr_engine="xla", bf_engine="xla",
                       subsel_engine="xla"),
           "blk": dict(corr_engine="pallas_blk", bf_engine="pallas",
                       subsel_engine="pallas"),
           "triu": dict(corr_engine="pallas_triu", bf_engine="xla",
                        subsel_engine="bands")}


def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


def need_devices(n=8):
    if len(jax.devices()) < n:
        pytest.skip(f"need {n} virtual devices")


def cpu_mesh(n_time, n_chan):
    return pm.make_mesh(n_time, n_chan, devices=["cpu"] * (n_time * n_chan))


def close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def eq(sharded, want):
    np.testing.assert_array_equal(pm.unshard(sharded).numpy(),
                                  np.asarray(want))


def gains_pairs(cfg, seed):
    """Integer gains in [-8, 8] (exact in every engine's arithmetic) and
    the default selection."""
    rng = np.random.RandomState(seed)
    gr, gi = (rng.randint(-8, 9, (cfg.nchan, cfg.nbeam, cfg.ninput))
              .astype(np.float32) for _ in range(2))
    _, _, _, pairs = px.default_inputs(cfg)
    return gr, gi, pairs.numpy()


def packed_gulp(rng, cfg, ntime):
    return rng.randint(0, 256, (ntime, cfg.nchan, cfg.ninput)) \
        .astype(np.uint8)


@pytest.mark.parametrize("engines", sorted(ENGINES))
def test_xengine_sharded_fn_matches_jax_and_unsharded(engines):
    need_devices()
    jcfg = JCFG.replace(**ENGINES[engines])
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(1)
    gr, gi, pairs = gains_pairs(cfg, 2)
    packed = packed_gulp(rng, cfg, 48)
    mesh = jmesh.make_mesh(2, 4)
    with jax.set_mesh(mesh):
        want = jax.jit(jmesh.xengine_sharded_fn(jcfg, mesh))(
            jnp.asarray(packed), JGains(jnp.asarray(gr), jnp.asarray(gi)),
            jnp.asarray(pairs))
        want = jax.tree.map(np.asarray, want)
    got = pm.xengine_sharded_fn(cfg, cpu_mesh(2, 4))(
        torch.from_numpy(packed), px.gains_from_numpy(gr, gi),
        torch.from_numpy(pairs))
    for g, w in zip((*got.vis, *got.subsel), (*want.vis, *want.subsel)):
        eq(g, w)
    close(pm.unshard(got.bf_power), want.bf_power)
    assert got.bf_power.shape == want.bf_power.shape
    plain = correlate_gulp(torch.from_numpy(packed))
    eq(got.vis.real, plain.real)
    eq(got.vis.imag, plain.imag)


STREAM = [(True, False, True), (False, True, True), (True, False, False),
          (False, True, False)]


@pytest.mark.parametrize("engines", sorted(ENGINES))
def test_stateful_stream_matches_jax_and_unsharded(engines):
    """Two fast windows of two gulps and the slow dump at their end."""
    need_devices()
    jcfg = JCFG.replace(**ENGINES[engines])
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(3)
    gr, gi, pairs = gains_pairs(cfg, 4)
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    pg = px.gains_from_numpy(gr, gi)
    jm, mesh = jmesh.make_mesh(2, 4), cpu_mesh(2, 4)
    jstate = jmesh.zero_sharded_state(jcfg, jm)
    state = pm.zero_sharded_state(cfg, mesh)
    ref = px.init_state(cfg)
    jsteps = {}
    for flags in STREAM:
        packed = packed_gulp(rng, cfg, cfg.ntime_gulp)
        if flags not in jsteps:
            jsteps[flags] = jax.jit(jmesh.xengine_sharded_state_fn(
                jcfg, jm, *flags))
        with jax.set_mesh(jm):
            jstate, jout, jvlbi = jsteps[flags](
                jstate, jnp.asarray(packed), jg, jnp.asarray(pairs))
            jout, jvlbi, jnp_state = jax.tree.map(
                np.asarray, (jout, jvlbi, jstate))
        state, out, vlbi = pm.xengine_sharded_state_fn(cfg, mesh, *flags)(
            state, torch.from_numpy(packed), pg, torch.from_numpy(pairs))
        ref, rout = px.xengine_step(ref, torch.from_numpy(packed), pg,
                                    torch.from_numpy(pairs), *flags, cfg)
        close(pm.unshard(vlbi), jvlbi)
        close(pm.unshard(out.bf_power), jout.bf_power)
        close(pm.unshard(vlbi), rout.vlbi)
        close(pm.unshard(out.bf_power), rout.bf_power)
        # the fast accumulator: per-time-shard partials, as in JAX
        for g, w in zip(state[0], jnp_state[0]):
            assert g.shape == w.shape == (2, cfg.nchan, cfg.ninput,
                                          cfg.ninput)
            up = np.triu(np.ones((cfg.ninput, cfg.ninput), bool))
            np.testing.assert_array_equal(pm.unshard(g).numpy()[..., up],
                                          w[..., up])
        if not flags[1]:
            assert out.vis is None and out.subsel is None
            continue
        fast = px.dense_vis(ref.vis_fast, cfg)
        for g, w, r in zip((*out.vis, *out.subsel), (*jout.vis, *jout.subsel),
                           (*fast, *rout.subsel)):
            eq(g, w)
            eq(g, r)
    slow = px.dense_vis(ref.vis_slow, cfg)
    for g, w, r in zip(state[1], jnp_state[1], slow):
        eq(g, w)
        eq(g, r)


def make_adc(rng, cfg, dtype, nspec):
    shape = (nspec * 2 * cfg.nchan, cfg.ninput)
    if dtype == "int8":
        return rng.randint(-90, 91, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 20).astype(np.float32)


def rms_scale(adc, cfg, per_channel):
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    re, _ = pfb.pfb_prequant_ref(torch.from_numpy(adc), w, cfg.nchan,
                                 cfg.pfb_ntap, 1.0)
    scale = np.float32(2.5 / float(re.std()))
    if per_channel:
        return (np.linspace(0.7, 1.3, cfg.nchan) * scale).astype(np.float32)
    return scale


def byte_gate(ext, w, cfg, jcfg, scale):
    """Threshold cases between the port's and JAX's channelizer bytes on
    the stream ``ext`` (history in front), through the packed-byte gate."""
    xt = torch.from_numpy(ext)
    got = pfb.channelize_pack_imajor(xt, w, cfg, torch.as_tensor(scale))
    pre = pfb.pfb_prequant_ref(xt, w, cfg.nchan, cfg.pfb_ntap,
                               torch.as_tensor(scale))
    want = np.asarray(jpfb.channelize_pack_imajor(
        jnp.asarray(ext), jnp.asarray(w), jcfg, jnp.asarray(scale)))
    return pfb.assert_packed_close(got, torch.from_numpy(want.copy()), pre)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_fx_sharded_fn_matches_jax_and_unsharded(dtype, per_channel):
    need_devices()
    jcfg = JCFG.replace(adc_dtype=dtype, **ENGINES["blk"])
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(5)
    gr, gi, pairs = gains_pairs(cfg, 6)
    adc = make_adc(rng, cfg, dtype, 8 * cfg.ntime_sum)
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    scale = rms_scale(adc, cfg, per_channel)
    jm = jmesh.make_mesh(2, 4)
    with jax.set_mesh(jm):
        want = jax.jit(jmesh.fx_sharded_fn(jcfg, jm))(
            jnp.asarray(adc), jnp.asarray(w),
            JGains(jnp.asarray(gr), jnp.asarray(gi)), jnp.asarray(pairs),
            jnp.asarray(scale))
        want = jax.tree.map(np.asarray, want)
    args = (torch.from_numpy(w), px.gains_from_numpy(gr, gi),
            torch.from_numpy(pairs), torch.as_tensor(scale))
    got = pm.fx_sharded_fn(cfg, cpu_mesh(2, 4))(torch.from_numpy(adc), *args)
    ref = pm.fx_reference_unsharded(cfg, torch.from_numpy(adc), *args,
                                    n_time_shards=2)
    for g, r in zip((*got.vis, *got.subsel), (*ref.vis, *ref.subsel)):
        eq(g, r)
    close(pm.unshard(got.bf_power), ref.bf_power)
    halo = np.zeros(((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput),
                    adc.dtype)
    tolerated = byte_gate(np.concatenate([halo, adc]), w, cfg, jcfg, scale)
    assert tolerated <= 1e-4 * adc.size   # one code pair per two samples
    if tolerated == 0:
        for g, j in zip((*got.vis, *got.subsel), (*want.vis, *want.subsel)):
            eq(g, j)
        close(pm.unshard(got.bf_power), want.bf_power)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_fx_sharded_state_fn_matches_jax_and_unsharded(dtype):
    """Two blocks with the carried tail between them; the second dumps."""
    need_devices()
    jcfg = JCFG.replace(adc_dtype=dtype, **ENGINES["blk"])
    cfg = port_cfg(jcfg)
    rng = np.random.RandomState(7)
    gr, gi, pairs = gains_pairs(cfg, 8)
    jg = JGains(jnp.asarray(gr), jnp.asarray(gi))
    pg = px.gains_from_numpy(gr, gi)
    w = pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    nhalo = (cfg.pfb_ntap - 1) * 2 * cfg.nchan
    blocks = [make_adc(rng, cfg, dtype, cfg.ntime_gulp) for _ in range(2)]
    scale = rms_scale(blocks[0], cfg, True)
    jm, mesh = jmesh.make_mesh(2, 4), cpu_mesh(2, 4)
    jstate = jmesh.zero_sharded_state(jcfg, jm)
    state = pm.zero_sharded_state(cfg, mesh)
    ref = px.init_state(cfg)
    tail = np.zeros((nhalo, cfg.ninput), blocks[0].dtype)
    tolerated = 0
    for adc, flags in zip(blocks, [(True, False, True), (False, True, True)]):
        with jax.set_mesh(jm):
            jstate, jout, jvlbi = jax.jit(jmesh.fx_sharded_state_fn(
                jcfg, jm, *flags))(
                jstate, jnp.asarray(adc), jnp.asarray(tail), jnp.asarray(w),
                jnp.asarray(scale), jg, jnp.asarray(pairs))
            jout, jvlbi = jax.tree.map(np.asarray, (jout, jvlbi))
        state, out, vlbi = pm.fx_sharded_state_fn(cfg, mesh, *flags)(
            state, torch.from_numpy(adc), torch.from_numpy(tail),
            torch.from_numpy(w), torch.from_numpy(scale), pg,
            torch.from_numpy(pairs))
        ext = np.concatenate([tail, adc])
        ref, rout = px.fx_step(ref, torch.from_numpy(ext),
                               torch.from_numpy(w), torch.from_numpy(scale),
                               pg, torch.from_numpy(pairs), *flags, cfg)
        tolerated += byte_gate(ext, w, cfg, jcfg, scale)
        close(pm.unshard(vlbi), rout.vlbi)
        close(pm.unshard(out.bf_power), rout.bf_power)
        if tolerated == 0:
            close(pm.unshard(vlbi), jvlbi)
            close(pm.unshard(out.bf_power), jout.bf_power)
        tail = adc[len(adc) - nhalo:]
    fast = px.dense_vis(ref.vis_fast, cfg)
    for g, r in zip((*out.vis, *out.subsel), (*fast, *rout.subsel)):
        eq(g, r)
    if tolerated == 0:
        for g, j in zip((*out.vis, *out.subsel), (*jout.vis, *jout.subsel)):
            eq(g, j)
    slow = px.dense_vis(ref.vis_slow, cfg)
    for g, r in zip(state[1], slow):
        eq(g, r)


@pytest.mark.parametrize("n_time,n_chan", [(1, 8), (8, 1), (4, 2), (1, 1)])
def test_other_mesh_shapes_match_the_unsharded_step(n_time, n_chan):
    cfg = port_cfg(JCFG.replace(**ENGINES["blk"]))
    rng = np.random.RandomState(9)
    gr, gi, pairs = gains_pairs(cfg, 10)
    pg, pairs = px.gains_from_numpy(gr, gi), torch.from_numpy(pairs)
    mesh = cpu_mesh(n_time, n_chan)
    state, ref = pm.zero_sharded_state(cfg, mesh), px.init_state(cfg)
    for flags in STREAM[:2]:
        packed = torch.from_numpy(packed_gulp(rng, cfg, 96))
        state, out, vlbi = pm.xengine_sharded_state_fn(cfg, mesh, *flags)(
            state, packed, pg, pairs)
        ref, rout = px.xengine_step(ref, packed, pg, pairs, *flags, cfg)
        close(pm.unshard(vlbi), rout.vlbi)
        close(pm.unshard(out.bf_power), rout.bf_power)
    fast = px.dense_vis(ref.vis_fast, cfg)
    for g, r in zip((*out.vis, *out.subsel, *state[1]),
                    (*fast, *rout.subsel, *px.dense_vis(ref.vis_slow, cfg))):
        eq(g, r)


def test_fx_halo_exchange_removes_shard_seams():
    """With four time shards the sharded channelizer equals the unsharded
    one on [zeros; adc] (no seams), and differs from shards that each
    start from zeros (the halo really crossed the boundaries)."""
    cfg = port_cfg(JCFG.replace(adc_dtype="int8", **ENGINES["xla"]))
    rng = np.random.RandomState(11)
    gr, gi, pairs = gains_pairs(cfg, 12)
    adc = torch.from_numpy(make_adc(rng, cfg, "int8", 8 * cfg.ntime_sum))
    w = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap))
    args = (w, px.gains_from_numpy(gr, gi), torch.from_numpy(pairs),
            torch.tensor(0.01))
    got = pm.fx_sharded_fn(cfg, cpu_mesh(4, 2))(adc, *args)
    halo = torch.zeros(((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput),
                       dtype=torch.int8)
    ref, _ = px.fx_step(px.init_state(cfg), torch.cat([halo, adc]), w,
                        args[3], args[1], args[2], True, True, True, cfg,
                        want_power=False, want_vlbi=False)
    eq(got.vis.real, px.dense_vis(ref.vis_fast, cfg).real)
    eq(got.vis.imag, px.dense_vis(ref.vis_fast, cfg).imag)
    t_local = adc.shape[0] // 4
    seams = sum(pm.fx_reference_unsharded(
        cfg, adc[s * t_local:(s + 1) * t_local], *args).vis.real
        for s in range(4))
    assert not torch.equal(pm.unshard(got.vis.real), seams)


def test_corr_stand_sharded_matches_jax_and_unsharded():
    need_devices(4)
    cfg = port_cfg(JCFG)
    rng = np.random.RandomState(13)
    packed = packed_gulp(rng, cfg, 48)
    jm = jmesh.make_stand_mesh(4)
    with jax.set_mesh(jm):
        want = jax.tree.map(np.asarray, jax.jit(
            jmesh.corr_stand_sharded_fn(JCFG, jm))(jnp.asarray(packed)))
    rows = pm.corr_stand_sharded_fn(cfg, pm.make_stand_mesh(
        4, ["cpu"] * 4))(torch.from_numpy(packed))
    assert rows[0].real.shape == (cfg.nchan, cfg.ninput // 4, cfg.ninput)
    got = pm.unshard_rows(rows)
    plain = correlate_gulp(torch.from_numpy(packed))
    for g, w, r in zip(got, want, plain):
        np.testing.assert_array_equal(g.numpy(), w)
        assert torch.equal(g, r)
    with pytest.raises(ValueError):
        pm.corr_stand_sharded_fn(cfg, pm.make_stand_mesh(3, ["cpu"] * 3))
    with pytest.raises(ValueError):
        pm.make_stand_mesh(4, ["cpu"] * 2)


@pytest.mark.parametrize("n_time,n_chan", [(1, 1), (2, 4), (4, 8)])
@pytest.mark.parametrize("adc_dtype", ["float32", "int8"])
def test_collective_volumes_equal_jax(n_time, n_chan, adc_dtype):
    jcfg = C.LWA352.replace(adc_dtype=adc_dtype)
    assert pm.collective_volumes(port_cfg(jcfg), n_time, n_chan) == \
        jmesh.collective_volumes(jcfg, n_time, n_chan)
    assert pm.collective_volumes(port_cfg(jcfg), n_time, n_chan, 480, 2400,
                                 want_vlbi=False) == \
        jmesh.collective_volumes(jcfg, n_time, n_chan, 480, 2400,
                                 want_vlbi=False)


def test_make_mesh_raises_without_enough_devices():
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices"):
        pm.make_mesh(have + 1, 2)
    with pytest.raises(ValueError, match="were given"):
        pm.make_mesh(2, 4, devices=["cpu"] * 7)
    with pytest.raises(ValueError):
        pm.make_mesh(3, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        pm.make_mesh(1, 1, devices=["meta"])
    mesh = pm.make_mesh(2, devices=["cpu"] * 8)
    assert mesh.shape == {"time": 2, "chan": 4}
    assert pm.make_mesh(2, 2, devices=["cpu"] * 8).shape["chan"] == 2


@pytest.mark.parametrize("build", ["xengine_sharded_fn",
                                   "xengine_sharded_state_fn",
                                   "fx_sharded_fn", "fx_sharded_state_fn",
                                   "zero_sharded_state"])
def test_184_channels_on_four_chan_shards_raise(build):
    """184 / 4 = 46 channels per shard is not a multiple of nchan_sum 4;
    two chan shards (92) pass."""
    cfg = TC.LWA352.replace(nchan=184)
    flags = (True, True, True) if "state_fn" in build else ()
    with pytest.raises(ValueError, match="nchan_sum"):
        getattr(pm, build)(cfg, cpu_mesh(1, 4), *flags)
    if build != "zero_sharded_state":
        getattr(pm, build)(cfg, cpu_mesh(2, 2), *flags)
    with pytest.raises(ValueError, match="divide"):
        pm.fx_sharded_fn(TC.TINY.replace(nchan=48), cpu_mesh(1, 3))


def test_shard_unshard_round_trip_and_bad_shapes():
    mesh = cpu_mesh(2, 4)
    x = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    for spec in [("time", "chan", None), ("chan", None, None),
                 (None, "time", None), (None, None, None),
                 (None, "chan", None)]:
        sx = pm.shard(mesh, x, spec)
        assert sx.shape == x.shape
        assert torch.equal(pm.unshard(sx), x)
    assert pm.shard(mesh, x, ("time", "chan"))[1, 3].shape == (2, 2, 3)
    # a shard on the value's own device is a view of it
    assert pm.shard(mesh, x, ("time",))[1, 0].data_ptr() == x[2:].data_ptr()
    with pytest.raises(ValueError, match="does not divide"):
        pm.shard(mesh, x, (None, None, "chan"))
    cfg = port_cfg(JCFG)
    gr, gi, pairs = gains_pairs(cfg, 1)
    with pytest.raises(ValueError, match="whole spectra"):
        pm.fx_sharded_fn(cfg, mesh)(
            torch.zeros((3 * 2 * cfg.nchan, cfg.ninput)),
            torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)),
            px.gains_from_numpy(gr, gi), torch.from_numpy(pairs), 1.0)
