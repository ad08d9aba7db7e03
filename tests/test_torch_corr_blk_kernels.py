"""The gulp correlator ``cbd_corr_blk``, the unpack-once pair
``cbd_corr_acc_cached`` (both in ``csrc/corr_acc.cu``) and the row-streamed
``csrc/corr_rows.cu`` against their plain versions, on the card; and the
sharded programs of ``parallel/mesh.py`` on a mesh whose four shards share
the one card.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU host
without JAX run it as ``python -m pytest --noconftest
tests/test_torch_corr_blk_kernels.py`` (the suite's conftest imports JAX).
Shapes are ragged (inputs not a multiple of the tile, times not a multiple
of the 64-sample chunk, of the 32-sample MMA step nor of the row kernel's
512-sample segment; 1, 31 and 33 spectra; 72, 300 and 704 inputs), padded
cti, strided shard views of a larger block, and production widths.  Checks
are exact int32 on every entry of the valid tiles; tiles below the diagonal
stay zero; the unpack-once state is bit-identical to the default kernel's.
"""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as C
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cb
from caltech_bifrost_dsp_tpu_torch.ops import corr_rows as cr
from caltech_bifrost_dsp_tpu_torch.ops.beamform import BeamGains
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import corr_acc, corr_acc_ref
from caltech_bifrost_dsp_tpu_torch.ops.correlate import Vis, chan_major
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

GULP = {"corr_blk": (cb.corr_blk, cb.corr_blk_ref, cb.TILE),
        "corr_rows": (cr.corr_rows, cr.corr_rows_ref, cr.TILE)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gulp(rng, dev, ntime, nchan, ni, layout, pad, view):
    """A packed block; ``view`` cuts it out of a larger one in time and
    chan, as a shard of a gulp on one card is cut."""
    if view:
        big = torch.from_numpy(rng.randint(
            0, 256, (2 * ntime, nchan + 3, ni + pad)).astype(np.uint8))
        return big.to(dev)[ntime // 2:ntime // 2 + ntime, 2:2 + nchan]
    shape = (ntime, nchan, ni) if layout == "tci" else (nchan, ntime, ni + pad)
    return torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)) \
        .to(dev)


SHAPES = [(50, 2, 72, "tci", 0, False), (33, 3, 130, "cti", 6, False),
          (1, 1, 256, "tci", 0, False), (997, 2, 300, "cti", 20, False),
          (513, 2, 140, "tci", 0, False), (1100, 3, 200, "tci", 8, True),
          (2400, 2, 704, "tci", 0, False), (480, 2, 704, "cti", 64, False),
          (1200, 2, 704, "tci", 0, True), (31, 2, 72, "tci", 3, True),
          (33, 1, 300, "tci", 0, False), (65, 2, 129, "tci", 1, True)]


@pytest.mark.parametrize("name", sorted(GULP))
@pytest.mark.parametrize("ntime,nchan,ni,layout,pad,view", SHAPES)
def test_gulp_correlator_matches_plain(dev, name, ntime, nchan, ni, layout,
                                       pad, view):
    fn, ref, tile_n = GULP[name]
    rng = np.random.RandomState(ni + ntime)
    packed = _gulp(rng, dev, ntime, nchan, ni, layout, pad, view)
    before = fn.launches
    got = fn(packed, layout, ni)
    want = ref(chan_major(packed, layout, ni))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    tile = torch.arange(ni, device=dev) // tile_n
    valid = tile[:, None] <= tile[None, :]
    for g, w in zip(got, want):
        assert g.shape == (nchan, ni, ni) and g.dtype == torch.int32
        assert torch.equal(g[:, valid], w[:, valid])
        assert not g[:, ~valid].any()


@pytest.mark.parametrize("name", sorted(GULP))
def test_gulp_correlator_refuses_bad_input(dev, name):
    fn = GULP[name][0]
    with pytest.raises(ValueError):
        fn(torch.zeros((8, 2, 40), dtype=torch.int8, device=dev))
    with pytest.raises(ValueError):
        fn(torch.zeros((8, 2, 40), dtype=torch.uint8, device=dev), ninput=41)
    with pytest.raises(ValueError):     # input axis not contiguous
        fn(torch.zeros((8, 40, 2), dtype=torch.uint8, device=dev)
           .permute(0, 2, 1))


@pytest.mark.parametrize("ntime,nchan,ni,layout,pad,view", [
    (50, 2, 72, "tci", 0, False), (97, 2, 300, "cti", 20, False),
    (330, 3, 140, "tci", 5, True), (2400, 2, 704, "tci", 0, False),
    (1, 1, 72, "tci", 0, False), (31, 2, 300, "tci", 0, True),
    (33, 2, 704, "cti", 64, False)])
def test_unpack_cache_matches_plain_and_default_kernel(dev, ntime, nchan, ni,
                                                       layout, pad, view):
    rng = np.random.RandomState(ni + ntime)
    packed = _gulp(rng, dev, ntime, nchan, ni, layout, pad, view)
    xc = chan_major(packed, layout, ni)
    upper = torch.triu(torch.ones((ni, ni), dtype=torch.bool, device=dev))
    for flags in [(True, False, False), (False, False, False),
                  (False, True, True), (False, True, False),
                  (True, True, False), (True, True, True)]:
        init = [torch.from_numpy(rng.randint(
            -2 ** 20, 2 ** 20, (nchan, ni, ni)).astype(np.int32)).to(dev)
            for _ in range(4)]
        want = [p.clone() for p in init]
        corr_acc_ref(xc, Vis(*want[:2]), Vis(*want[2:]), *flags)
        default = [p.clone() for p in init]
        corr_acc(packed, Vis(*default[:2]), Vis(*default[2:]), *flags,
                 layout=layout)
        before = (corr_acc.launches, corr_acc.cached_launches)
        corr_acc(packed, Vis(*init[:2]), Vis(*init[2:]), *flags,
                 layout=layout, unpack_cache=True)
        torch.cuda.synchronize()
        assert (corr_acc.launches, corr_acc.cached_launches) == (
            before[0], before[1] + 1)
        for g, w, d in zip(init, want, default):
            assert torch.equal(g[:, upper], w[:, upper])
            assert torch.equal(g, d)    # bit-identical, lower tiles too


def _mesh_inputs(cfg, dev, seed):
    rng = np.random.RandomState(seed)
    gains = BeamGains(*(torch.from_numpy(rng.randint(
        -8, 9, (cfg.nchan, cfg.nbeam, cfg.ninput)).astype(np.float32))
        .to(dev) for _ in range(2)))
    _, _, _, pairs = px.default_inputs(cfg)
    return rng, gains, pairs.to(dev)


@pytest.mark.parametrize("engine", ["pallas_blk", "pallas_triu", "xla"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_sharded_state_stream_on_one_card(dev, engine, shape):
    """Two fast windows and a slow dump through the stateful sharded step
    on four shards of one card equal the unsharded step: integers exact,
    power within rtol 1e-4, VLBI exact (integer gains)."""
    cfg = C.TINY.replace(nstand=36, nchan=16, ntime_gulp=96, acc_len=192,
                         acc_len_slow=384, corr_engine=engine)
    mesh = pm.make_mesh(*shape, devices=[dev] * 4)
    rng, gains, pairs = _mesh_inputs(cfg, dev, 3)
    state = pm.zero_sharded_state(cfg, mesh)
    ref = px.init_state(cfg, dev)
    before = cb.corr_blk.launches
    flags = [(True, False, True), (False, True, True),
             (True, False, False), (False, True, False)]
    for ff, fl, sf in flags:
        gulp = torch.from_numpy(rng.randint(
            0, 256, (cfg.ntime_gulp, cfg.nchan, cfg.ninput))
            .astype(np.uint8)).to(dev)
        step = pm.xengine_sharded_state_fn(cfg, mesh, ff, fl, sf)
        state, out, vlbi = step(state, gulp, gains, pairs)
        ref, want = px.xengine_step(ref, gulp, gains, pairs, ff, fl, sf, cfg)
        torch.cuda.synchronize()
        assert torch.equal(pm.unshard(vlbi), want.vlbi)
        power = pm.unshard(out.bf_power)
        assert torch.allclose(power, want.bf_power, rtol=1e-4,
                              atol=1e-4 * float(want.bf_power.abs().max()))
        if fl:
            fast = px.dense_vis(ref.vis_fast, cfg)
            for g, w in zip(out.vis, fast):
                assert torch.equal(pm.unshard(g), w)
            for g, w in zip(out.subsel, want.subsel):
                assert torch.equal(pm.unshard(g), w)
    slow = px.dense_vis(ref.vis_slow, cfg)
    for g, w in zip(state[1], slow):
        assert torch.equal(pm.unshard(g), w)
    nlaunch = cb.corr_blk.launches - before
    assert nlaunch == (4 * len(flags) if engine == "pallas_blk" else 0)


def test_sharded_fx_on_one_card_matches_unsharded(dev):
    """One FX window through ``fx_sharded_state_fn`` at 2x2 with a carried
    tail: integers equal to the unsharded ``fx_step`` on the same ADC."""
    cfg = C.TINY.replace(nstand=36, nchan=16, ntime_gulp=96, acc_len=96,
                         acc_len_slow=96, adc_dtype="int8",
                         corr_engine="pallas_blk")
    mesh = pm.make_mesh(2, 2, devices=[dev] * 4)
    rng, gains, pairs = _mesh_inputs(cfg, dev, 4)
    L = 2 * cfg.nchan
    halo = (cfg.pfb_ntap - 1) * L
    adc = torch.from_numpy(rng.randint(
        -90, 91, (halo + cfg.ntime_gulp * L, cfg.ninput)).astype(np.int8)) \
        .to(dev)
    from caltech_bifrost_dsp_tpu_torch.ops.pfb import pfb_window
    window = torch.from_numpy(pfb_window(cfg.nchan, cfg.pfb_ntap)).to(dev)
    scale = torch.tensor(0.02, device=dev)
    step = pm.fx_sharded_state_fn(cfg, mesh, True, True, True)
    state, out, vlbi = step(pm.zero_sharded_state(cfg, mesh), adc[halo:],
                            adc[:halo], window, scale, gains, pairs)
    ref, want = px.fx_step(px.init_state(cfg, dev), adc, window, scale,
                           gains, pairs, True, True, True, cfg)
    torch.cuda.synchronize()
    fast = px.dense_vis(ref.vis_fast, cfg)
    for g, w in zip(out.vis, fast):
        assert torch.equal(pm.unshard(g), w)
    for g, w in zip(out.subsel, want.subsel):
        assert torch.equal(pm.unshard(g), w)
    assert torch.equal(pm.unshard(vlbi), want.vlbi)
    assert torch.allclose(pm.unshard(out.bf_power), want.bf_power, rtol=1e-4,
                          atol=1e-4 * float(want.bf_power.abs().max()))
