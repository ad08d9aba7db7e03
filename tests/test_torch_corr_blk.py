"""``corr_blk``, ``corr_acc(unpack_cache=True)`` and ``corr_rows`` (plain
paths, on the CPU) against the TPU kernels they port, run in interpret
mode: ``packed_corr_blk``, ``packed_corr_blk_acc(unpack_cache=True)`` and
``packed_corr_rows``.  Exact int32 on the valid tiles (128-input tiles for
``corr_blk`` and ``corr_rows``, ``j >= i`` for the accumulating
correlator), at ragged, tile-multiple and 184-channel shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops.correlate import Vis as JVis
from caltech_bifrost_dsp_tpu.ops.pallas.corr_blk import (packed_corr_blk,
                                                         packed_corr_blk_acc,
                                                         padded_ni)
from caltech_bifrost_dsp_tpu.ops.pallas.corr_rows import packed_corr_rows
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cb
from caltech_bifrost_dsp_tpu_torch.ops import corr_rows as cr
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import (cache_shape, corr_acc,
                                                        corr_acc_ref,
                                                        unpack_planes_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import (Vis, chan_major,
                                                         mirror_vis)

torch.set_num_threads(1)

# (ntime, nchan, ninput): ragged inputs and times, and 184 channels
SHAPES = [(24, 4, 32), (50, 2, 72), (33, 3, 130), (17, 184, 24),
          (48, 2, 300)]
GULP = {"corr_blk": (cb.corr_blk, cb.corr_blk_ref, cb.TILE, packed_corr_blk),
        "corr_rows": (cr.corr_rows, cr.corr_rows_ref, cr.TILE,
                      packed_corr_rows)}


def valid_tiles(ni, tile):
    t = np.arange(ni) // tile
    return t[:, None] <= t[None, :]


@pytest.mark.parametrize("name", sorted(GULP))
@pytest.mark.parametrize("ntime,nchan,ni", SHAPES)
def test_gulp_correlator_matches_tpu_kernel(name, ntime, nchan, ni):
    fn, ref, tile, jfn = GULP[name]
    rng = np.random.RandomState(ntime + ni)
    packed = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
    want = jfn(jnp.asarray(packed), interpret=True)
    got = fn(torch.from_numpy(packed))
    valid = valid_tiles(ni, tile)
    for g, w in zip(got, want):
        assert g.shape == (nchan, ni, ni) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy()[:, valid],
                                      np.asarray(w)[:, valid])
    # the TPU kernels' own validity (256-blocks, 128-row strips) covers
    # the upper triangle, which is all a consumer reads after the mirror
    dense = mirror_vis(got)
    plain = ref(chan_major(torch.from_numpy(packed), "tci"))
    assert torch.equal(dense.real, plain.real)
    assert torch.equal(dense.imag, plain.imag)


@pytest.mark.parametrize("name", sorted(GULP))
def test_gulp_correlator_layouts_views_and_counts(name):
    fn = GULP[name][0]
    rng = np.random.RandomState(3)
    big = torch.from_numpy(rng.randint(0, 256, (40, 7, 50)).astype(np.uint8))
    view = big[8:28, 2:6]                  # a shard of a larger block
    want = fn(view.contiguous())
    before = fn.launches
    got = fn(view)
    cti = fn(torch.nn.functional.pad(view.permute(1, 0, 2), (0, 14)), "cti",
             50)
    assert fn.launches == before           # no kernel on the CPU
    for g, c, w in zip(got, cti, want):
        assert torch.equal(g, w) and torch.equal(c, w)
    with pytest.raises(ValueError):
        fn(view, "itc")
    with pytest.raises(ValueError):
        fn(view, "tci", 51)


FLAGS = [(True, False, False), (False, False, False), (False, True, True),
         (False, True, False), (True, True, False), (True, True, True)]


@pytest.mark.parametrize("unpack_cache", [True, None])
@pytest.mark.parametrize("ntime,nchan,ni", [(24, 4, 32), (33, 3, 130),
                                            (17, 184, 24), (64, 1, 128)])
def test_unpack_cache_matches_tpu_cached_kernel(ntime, nchan, ni,
                                                unpack_cache):
    """The flag cycle through ``corr_acc(unpack_cache=...)`` and through
    ``packed_corr_blk_acc(unpack_cache=...)`` (interpret mode) on carried
    state, for ``True`` and for ``None`` (each side's own default): equal
    on ``j >= i`` after every call, and equal to the port's
    ``unpack_cache=False`` and ``True``."""
    rng = np.random.RandomState(ni)
    nip = padded_ni(ni)
    up = np.triu(np.ones((ni, ni), bool))
    planes = [rng.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni)).astype(np.int32)
              for _ in range(4)]

    def padded(p):
        out = np.zeros((nchan, nip, nip), np.int32)
        out[:, :ni, :ni] = p
        return jnp.asarray(out)

    jfast = JVis(padded(planes[0]), padded(planes[1]))
    jslow = JVis(padded(planes[2]), padded(planes[3]))
    cached = [torch.from_numpy(p.copy()) for p in planes]
    others = {uc: [torch.from_numpy(p.copy()) for p in planes]
              for uc in (False, True)}
    for flags in FLAGS:
        packed = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
        jfast, jslow = packed_corr_blk_acc(
            jnp.asarray(packed), jfast, jslow, *flags,
            unpack_cache=unpack_cache, interpret=True)
        corr_acc(torch.from_numpy(packed), Vis(*cached[:2]),
                 Vis(*cached[2:]), *flags, unpack_cache=unpack_cache)
        for uc, st in others.items():
            corr_acc(torch.from_numpy(packed), Vis(*st[:2]), Vis(*st[2:]),
                     *flags, unpack_cache=uc)
        for g, d, e, w in zip(cached, others[False], others[True],
                              (*jfast, *jslow)):
            assert torch.equal(g, d) and torch.equal(g, e)
            np.testing.assert_array_equal(
                g.numpy()[:, up], np.asarray(w)[:, :ni, :ni][:, up])


def test_unpack_cache_plain_path_and_scratch_shape():
    rng = np.random.RandomState(5)
    packed = torch.from_numpy(rng.randint(0, 256, (20, 3, 40))
                              .astype(np.uint8))
    a = [torch.zeros((3, 40, 40), dtype=torch.int32) for _ in range(4)]
    b = [torch.zeros((3, 40, 40), dtype=torch.int32) for _ in range(4)]
    before = (corr_acc.launches, corr_acc.cached_launches)
    corr_acc(packed.permute(1, 0, 2).contiguous(), Vis(*a[:2]), Vis(*a[2:]),
             True, True, True, layout="cti", unpack_cache=True)
    corr_acc_ref(chan_major(packed, "tci"), Vis(*b[:2]), Vis(*b[2:]), True,
                 True, True)
    assert (corr_acc.launches, corr_acc.cached_launches) == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # [nchan, 3 planes, words of 4 samples padded to 64-sample chunks,
    # inputs padded to 128-tiles]: 1.1 GB of int32 at the production shape
    assert cache_shape(192, 2400, 704) == (192, 3, 608, 768)
    assert cache_shape(3, 33, 130) == (3, 3, 16, 256)
    assert cache_shape(1, 0, 1) == (1, 3, 0, 128)


@pytest.mark.parametrize("ntime,nchan,ni", [(33, 2, 130), (64, 1, 128),
                                            (1, 3, 5), (0, 1, 7)])
def test_unpack_planes_ref_is_the_numpy_unpack(ntime, nchan, ni):
    """The plain prepass, element by element: byte u of word q of input i
    in plane p is sample 4 q + u of (re, im, -re), sign-extended; zero past
    the block's edges."""
    rng = np.random.RandomState(ntime + ni)
    xc = rng.randint(0, 256, (nchan, ntime, ni)).astype(np.uint8)
    if ntime:
        xc[0, 0, 0] = 0x88              # both nibbles -8: -re = +8 fits
    got = unpack_planes_ref(torch.from_numpy(xc))
    assert tuple(got.shape) == cache_shape(nchan, ntime, ni)
    assert got.dtype == torch.int32
    samples = got.numpy().view(np.int8).reshape(*got.shape, 4)
    re = (xc >> 4).astype(np.int8)
    re = np.where(re > 7, re - 16, re)
    im = (xc & 15).astype(np.int8)
    im = np.where(im > 7, im - 16, im)
    for p, plane in enumerate((re, im, -re)):
        want = np.zeros((nchan, 4 * got.shape[2], got.shape[3]), np.int8)
        want[:, :ntime, :ni] = plane
        np.testing.assert_array_equal(
            samples[:, p].transpose(0, 1, 3, 2).reshape(want.shape), want)
