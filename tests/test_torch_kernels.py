"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU host
without JAX run them as ``python -m pytest --noconftest
tests/test_torch_kernels.py`` (the suite's conftest imports JAX).  Shapes
are small and ragged (inputs not a multiple of the 128-input tile, times
not a multiple of the 64-sample chunk, of the 32-sample MMA step or of the
96-sample beam tile) plus one production-width case per kernel; the
correlator also takes a structured block (a distinct value per input and
per time sample) and one of 0x88 bytes (both nibbles -8).
"""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cb
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import corr_acc, corr_acc_ref
from caltech_bifrost_dsp_tpu_torch.ops.correlate import Vis, chan_major

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

FLAGS = [(True, False, False), (False, False, False), (False, True, True),
         (False, True, False), (True, True, False), (True, True, True)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _packed(rng, layout, ntime, nchan, ni, pad, dev, kind="random"):
    shape = (ntime, nchan, ni) if layout == "tci" else (nchan, ntime, ni + pad)
    if kind == "random":
        packed = rng.randint(0, 256, shape).astype(np.uint8)
    elif kind == "widest":
        packed = np.full(shape, 0x88, np.uint8)
    else:       # structured: distinct per input, time sample and channel
        a, b, i = np.meshgrid(*(np.arange(n) for n in shape), indexing="ij")
        packed = ((i * 7 + a * 13 + b * 29) % 256).astype(np.uint8)
    return torch.from_numpy(packed).to(dev)


@pytest.mark.parametrize("unpack_cache", [False, True])
@pytest.mark.parametrize("ntime,nchan,ni,layout,pad,kind", [
    (50, 2, 72, "tci", 0, "random"), (33, 3, 130, "cti", 6, "random"),
    (2400, 2, 704, "tci", 0, "random"), (480, 2, 704, "cti", 64, "random"),
    (997, 3, 300, "cti", 20, "random"), (1, 1, 72, "tci", 0, "random"),
    (31, 2, 300, "tci", 0, "structured"), (33, 1, 704, "tci", 0, "structured"),
    (2400, 1, 300, "tci", 0, "widest"), (130, 2, 257, "cti", 3, "structured")])
def test_corr_acc_matches_plain(dev, ntime, nchan, ni, layout, pad, kind,
                                unpack_cache):
    """Exact int32 on the upper-valid tiles for every flag combination;
    tiles below the diagonal are left untouched."""
    rng = np.random.RandomState(ni + ntime)
    packed = _packed(rng, layout, ntime, nchan, ni, pad, dev, kind)
    tile = torch.arange(ni, device=dev) // cb.TILE
    valid = tile[:, None] <= tile[None, :]
    for flags in FLAGS:
        init = [torch.from_numpy(rng.randint(-999, 999, (nchan, ni, ni))
                                 .astype(np.int32)).to(dev) for _ in range(4)]
        want = [p.clone() for p in init]
        corr_acc_ref(chan_major(packed, layout, ni), Vis(*want[:2]),
                     Vis(*want[2:]), *flags)
        got = [p.clone() for p in init]
        corr_acc(packed, Vis(*got[:2]), Vis(*got[2:]), *flags, layout=layout,
                 unpack_cache=unpack_cache)
        torch.cuda.synchronize()
        for g, w, s in zip(got, want, init):
            assert torch.equal(g[:, valid], w[:, valid]), flags
            assert torch.equal(g[:, ~valid], s[:, ~valid]), flags


@pytest.mark.parametrize("ntime,nchan,ni,nbeam,ntime_sum,layout,pad", [
    (48, 2, 40, 4, 12, "tci", 0), (240, 2, 70, 32, 24, "cti", 10),
    (120, 1, 64, 6, 20, "tci", 0), (2400, 2, 704, 32, 24, "tci", 0)])
@pytest.mark.parametrize("integer_gains", [True, False])
def test_beamform_products_matches_plain(dev, ntime, nchan, ni, nbeam,
                                         ntime_sum, layout, pad,
                                         integer_gains):
    """Integer gains: VLBI exact (every partial sum is an integer below
    2^24).  Power, and VLBI for float gains: rtol 1e-4 with atol 1e-4 *
    max|plain|, because fp32 sums run in another order and the XY cross
    terms cancel."""
    rng = np.random.RandomState(ni + nbeam)
    packed = _packed(rng, layout, ntime, nchan, ni, pad, dev)
    if integer_gains:
        g = [rng.randint(-8, 9, (nchan, nbeam, ni)) for _ in range(2)]
    else:
        g = [rng.randn(nchan, nbeam, ni) for _ in range(2)]
    gains = bf.BeamGains(*(torch.from_numpy(x.astype(np.float32)).to(dev)
                           for x in g))
    want_p, want_v = bf.beamform_products_ref(
        chan_major(packed, layout, ni), gains, ntime_sum)
    power, vlbi = bf.beamform_products(packed, gains, ntime_sum,
                                       layout=layout)
    torch.cuda.synchronize()
    assert torch.allclose(power, want_p, rtol=1e-4,
                          atol=1e-4 * float(want_p.abs().max()))
    if integer_gains:
        assert torch.equal(vlbi, want_v)
    else:
        assert torch.allclose(vlbi, want_v, rtol=1e-4,
                              atol=1e-4 * float(want_v.abs().max()))
    p_only, none = bf.beamform_products(packed, gains, ntime_sum,
                                        want_vlbi=False, layout=layout)
    assert none is None and torch.equal(p_only, power)


@pytest.mark.parametrize("nchan,ni,nchan_sum", [(8, 72, 4), (192, 704, 4)])
def test_corr_subsel_matches_plain(dev, nchan, ni, nchan_sum):
    """Exact, including out-of-range and negative pairs (clamped)."""
    rng = np.random.RandomState(nchan)
    vis = Vis(*(torch.from_numpy(rng.randint(-999, 999, (nchan, ni, ni))
                                 .astype(np.int32)).to(dev)
                for _ in range(2)))
    pairs = np.concatenate([
        cs.baselines_to_inputs(cs.production_baselines(4704, ni // 2)),
        [[ni + 5, 2], [3, 800], [-1, 4], [900, 900], [7, 7]]])
    pairs = torch.from_numpy(pairs.astype(np.int32)).to(dev)
    want = cs.corr_subsel_ref(vis, pairs, nchan_sum)
    got = cs.corr_subsel(vis, pairs, nchan_sum)
    torch.cuda.synchronize()
    assert torch.equal(got.real, want.real)
    assert torch.equal(got.imag, want.imag)


def test_launch_counters_count_kernel_launches(dev):
    packed = torch.zeros((48, 4, 16), dtype=torch.uint8, device=dev)
    vis = [torch.zeros((4, 16, 16), dtype=torch.int32, device=dev)
           for _ in range(4)]
    gains = bf.BeamGains(*(torch.ones((4, 2, 16), device=dev)
                           for _ in range(2)))
    pairs = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    def counts():
        return (corr_acc.launches, corr_acc.cached_launches,
                bf.beamform_products.launches, cs.corr_subsel.launches)

    before = counts()
    corr_acc(packed, Vis(*vis[:2]), Vis(*vis[2:]), True, True, True,
             unpack_cache=False)
    # the default schedule is the unpack-once pair
    corr_acc(packed, Vis(*vis[:2]), Vis(*vis[2:]), True, True, True)
    bf.beamform_products(packed, gains, 12)
    cs.corr_subsel(Vis(*vis[:2]), pairs, 4)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1]


@pytest.mark.parametrize("layout", ["tci", "cti"])
def test_xengine_step_on_card_matches_cpu(dev, layout):
    """The fused step on the card against the same step on CPU tensors
    (plain versions) over a full fast+slow cycle at a ragged geometry."""
    from caltech_bifrost_dsp_tpu_torch.config import TINY
    from caltech_bifrost_dsp_tpu_torch.models import xengine as px

    cfg = TINY.replace(nstand=36, nchan=8)
    rng = np.random.RandomState(11)
    gains = px.gains_from_numpy(
        *(rng.randint(-8, 9, (cfg.nchan, cfg.nbeam, cfg.ninput))
          for _ in range(2)))
    pairs = torch.from_numpy(np.concatenate([
        cs.baselines_to_inputs(cs.default_baselines(cfg.nvis_out,
                                                    cfg.nstand)),
        [[800, 3], [-1, 4]]]).astype(np.int32))
    states = {d: px.init_state(cfg, d) for d in ("cpu", dev)}
    for flags in FLAGS + [(False, True, False)]:
        gulp = rng.randint(0, 256, (cfg.ntime_gulp, cfg.nchan, cfg.ninput))
        if layout == "cti":
            staged = np.full((cfg.nchan, cfg.ntime_gulp, 96), 0xE1)
            staged[:, :, :cfg.ninput] = gulp.transpose(1, 0, 2)
            gulp = staged
        packed = torch.from_numpy(gulp.astype(np.uint8))
        outs = {}
        for d in states:
            states[d], outs[d] = px.xengine_step(
                states[d], packed.to(d), px.BeamGains(*(g.to(d)
                                                        for g in gains)),
                pairs.to(d), *flags, cfg, layout=layout)
        for v_cpu, v_dev in zip(states["cpu"], states[dev]):
            a, b = px.dense_vis(v_cpu, cfg), px.dense_vis(v_dev, cfg)
            assert torch.equal(a.real, b.real.cpu()), flags
            assert torch.equal(a.imag, b.imag.cpu()), flags
        o_cpu, o_dev = outs["cpu"], outs[dev]
        if flags[1]:
            assert torch.equal(o_cpu.subsel.real, o_dev.subsel.real.cpu())
            assert torch.equal(o_cpu.subsel.imag, o_dev.subsel.imag.cpu())
        assert torch.equal(o_cpu.vlbi, o_dev.vlbi.cpu())
        assert torch.allclose(o_dev.bf_power.cpu(), o_cpu.bf_power,
                              rtol=1e-4,
                              atol=1e-4 * float(o_cpu.bf_power.abs().max()))


def test_cli_golden_gate_on_card(dev, tmp_path, capsys):
    from caltech_bifrost_dsp_tpu_torch.scripts import pipeline
    from caltech_bifrost_dsp_tpu_torch.verification import golden

    ntime, nchan, nstand, acc = 960, 16, 16, 240
    in_path = golden.input_filename(str(tmp_path), ntime, nchan, nstand, 2)
    corr_path = golden.corr_filename(str(tmp_path), ntime, acc, nchan,
                                     nstand, 2)
    golden.write_input_file(in_path, ntime, nchan, nstand, 2, acc)
    golden.write_corr_file(corr_path, ntime, nchan, nstand, 2, acc)
    rc = pipeline.main([
        "--fakesource", "--testdatain", in_path, "--testdatacorr", corr_path,
        "--testdatacorr_acc_len", str(acc), "--nchan", str(nchan),
        "--nstand", str(nstand), "--nbeam", "4", "--ntime_gulp", "48",
        "--acc_len", str(acc), "--acc_len_slow", str(2 * acc),
        "--ngulp", str(ntime // 48), "--device", "cuda"])
    assert rc == 0
    assert "golden check: 2/2 passed" in capsys.readouterr().out
