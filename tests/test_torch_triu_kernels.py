"""``csrc/corr_triu.cu`` against its plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU host
without JAX run it as ``python -m pytest --noconftest
tests/test_torch_triu_kernels.py`` (the suite's conftest imports JAX).
Shapes are ragged (inputs not a multiple of the 128-input tile, times not
a multiple of the 32-sample stage), padded cti, and one production-width
case.  The check is exact int32 on every entry of the tiles with tile(j)
>= tile(i); the tiles below the diagonal stay zero.
"""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as C
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
from caltech_bifrost_dsp_tpu_torch.ops.corr_triu import (TILE, corr_triu,
                                                         corr_triu_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import chan_major

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("ntime,nchan,ni,layout,pad", [
    (50, 2, 72, "tci", 0), (33, 3, 130, "cti", 6), (1, 1, 256, "tci", 0),
    (97, 2, 300, "cti", 20), (2400, 2, 704, "tci", 0),
    (480, 2, 704, "cti", 64)])
def test_corr_triu_matches_plain(dev, ntime, nchan, ni, layout, pad):
    rng = np.random.RandomState(ni + ntime)
    shape = (ntime, nchan, ni) if layout == "tci" else (nchan, ntime, ni + pad)
    packed = torch.from_numpy(rng.randint(0, 256, shape).astype(np.uint8)) \
        .to(dev)
    before = corr_triu.launches
    got = corr_triu(packed, layout, ni)
    want = corr_triu_ref(chan_major(packed, layout, ni))
    torch.cuda.synchronize()
    assert corr_triu.launches == before + 1
    tile = torch.arange(ni, device=dev) // TILE
    valid = tile[:, None] <= tile[None, :]
    for g, w in zip(got, want):
        assert g.shape == (nchan, ni, ni) and g.dtype == torch.int32
        assert torch.equal(g[:, valid], w[:, valid])
        assert not g[:, ~valid].any()


def test_corr_triu_refuses_bad_input(dev):
    packed = torch.zeros((8, 2, 40), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        corr_triu(packed)
    with pytest.raises(ValueError):
        corr_triu(torch.zeros((8, 2, 40), dtype=torch.uint8, device=dev),
                  ninput=41)


def test_triu_step_on_the_card_matches_the_cpu(dev):
    """The pallas_triu step (kernel + in-place algebra) on the card equals
    its plain version on the CPU over a window cycle, after dense_vis."""
    cfg = C.TINY.replace(nstand=68, nchan=8, corr_engine="pallas_triu",
                         subsel_engine="pallas")
    rng = np.random.RandomState(9)
    states = [px.init_state(cfg), px.init_state(cfg, dev)]
    _, _, gains, pairs = px.default_inputs(cfg)
    for flags in [(True, False, False), (False, True, True),
                  (True, True, False)]:
        gulp = torch.from_numpy(rng.randint(
            0, 256, (cfg.ntime_gulp, cfg.nchan, cfg.ninput))
            .astype(np.uint8))
        outs = []
        for state, d in zip(states, ("cpu", dev)):
            g = px.BeamGains(*(x.to(d) for x in gains))
            outs.append(px.xengine_step(state, gulp.to(d), g, pairs.to(d),
                                        *flags, cfg)[1])
        torch.cuda.synchronize()
        for a, b in zip(states[0], states[1]):
            da, db = px.dense_vis(a, cfg), px.dense_vis(b, cfg)
            assert torch.equal(da.real, db.real.cpu())
            assert torch.equal(da.imag, db.imag.cpu())
        if flags[1]:
            assert torch.equal(outs[0].subsel.real, outs[1].subsel.real.cpu())
            assert torch.equal(outs[0].subsel.imag, outs[1].subsel.imag.cpu())
