"""The plain reference against the port's plain path at ``config.TINY``,
the decoders against the port's encoders, and the frozen bounds against
hand-worked values at LWA-352 width."""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.ops import beamform as pbf
from caltech_bifrost_dsp_tpu_torch.ops import correlate as pcorr
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as psub
from caltech_bifrost_dsp_tpu_torch.ops import pfb as ppfb
from xbench import roofline
from xbench.reference import decode
from xbench.reference import xengine as xr

CFG = TINY


def packed(seed: int, ntime: int = CFG.ntime_gulp) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (ntime, CFG.nchan, CFG.ninput),
                         generator=g, dtype=torch.uint8)


def test_correlation_equals_the_port():
    x = packed(1)
    want = pcorr.correlate_gulp(x)
    vr, vi = xr.correlate(*xr.unpack(x.permute(1, 0, 2)))
    assert torch.equal(vr.to(torch.int32), want.real)
    assert torch.equal(vi.to(torch.int32), want.imag)


def test_beam_products_equal_the_port():
    x = packed(2)
    rng = np.random.default_rng(3)
    delays = rng.uniform(-500, 500, (CFG.nbeam, CFG.ninput))
    amps = rng.uniform(0.1, 1, (CFG.nbeam, CFG.ninput))
    freqs = (CFG.chan0 + np.arange(CFG.nchan)) * CFG.chan_bw_hz
    # the driver's Beamform command: amps * exp(2j pi f delay) as complex64
    ph = np.exp(1j * 2 * np.pi * freqs[:, None, None] * delays[None] * 1e-9)
    gains = pbf.BeamGains.from_complex((amps[None] * ph).astype(np.complex64))
    power, vlbi = pbf.beamform_products(x, gains, CFG.ntime_sum)
    gr, gi = xr.beam_gains(delays, amps, CFG.nchan, CFG.chan0,
                           CFG.chan_bw_hz, "cpu")
    br, bi = xr.beams(*xr.unpack(x.permute(1, 0, 2)), gr, gi)
    rp = xr.power(br, bi, CFG.ntime_sum)
    rv = xr.vlbi(br, bi)
    assert rp.shape == power.shape and rv.shape == vlbi.shape
    assert torch.allclose(power.double(), rp, rtol=1e-5,
                          atol=1e-6 * float(rp.abs().max()))
    assert torch.allclose(vlbi.double(), rv, rtol=1e-5,
                          atol=1e-6 * float(rv.abs().max()))


def test_subselection_equals_the_port():
    x = packed(4)
    vis = pcorr.correlate_gulp(x)
    bl = [[[i % CFG.nstand, i % 2], [(3 * i) % CFG.nstand, (i // 2) % 2]]
          for i in range(64)]
    pairs = psub.baselines_to_inputs(bl, CFG.npol)
    want = psub.corr_subsel_ref(vis, torch.from_numpy(pairs.astype(
        np.int32)), CFG.nchan_sum)
    vr, vi = xr.correlate(*xr.unpack(x.permute(1, 0, 2)))
    sr, si = xr.subsel(vr, vi, pairs, CFG.nchan_sum)
    assert torch.equal(sr.to(torch.int32), want.real)
    assert torch.equal(si.to(torch.int32), want.imag)


def test_production_selection_is_the_ports():
    want = psub.production_baselines(4704, 352, 2)
    assert np.array_equal(xr.production_baselines(48, 2), np.array(want))


def test_channelizer_codes_equal_the_port():
    cfg = CFG.replace(adc_dtype="int8")
    assert np.array_equal(xr.pfb_window(cfg.nchan, cfg.pfb_ntap),
                          ppfb.pfb_window(cfg.nchan, cfg.pfb_ntap))
    g = torch.Generator().manual_seed(5)
    ntime = (cfg.ntime_gulp + cfg.pfb_ntap - 1) * 2 * cfg.nchan
    adc = (torch.randn((ntime, cfg.ninput), generator=g) * 32).round(
        ).clamp(-127, 127).to(torch.int8)
    window = ppfb.pfb_window(cfg.nchan, cfg.pfb_ntap)
    got = ppfb.pfb_quantize_packed_ref(adc, torch.from_numpy(window),
                                       cfg.nchan, cfg.pfb_ntap, 1.0)
    re, im = xr.channelize_codes(adc, xr.pfb_window(cfg.nchan,
                                                    cfg.pfb_ntap),
                                 cfg.nchan, cfg.pfb_ntap, 1.0, chunk=8)
    ur, ui = xr.unpack(got.permute(1, 2, 0))     # [spec, chan, input]
    assert torch.equal(ur.to(torch.int8), re)
    assert torch.equal(ui.to(torch.int8), im)


def test_decoders_read_the_ports_packets():
    rng = np.random.default_rng(6)
    bl = rng.integers(0, 352, (16, 2, 2)).astype(np.uint32)
    data = rng.integers(-2 ** 31, 2 ** 31, (16, 48, 2)).astype(np.int32)
    hdr = pk.CorrPartHeader(sync_time=7, spectra_id=2400 * 9, bw_hz=4.5e6,
                            sfreq_hz=1.25, acc_len=2400, nvis=16, nchans=48,
                            chan0=0)
    h, b2, d2 = decode.part(pk.encode_corr_part(hdr, bl, data))
    assert h == vars(hdr)
    assert np.array_equal(b2, bl) and np.array_equal(d2, data)
    pw = rng.standard_normal((192, 1, 4)).astype(np.float32)
    ph = pk.PBeamHeader(server=1, beam=5, gbe=0, nchan=192, nbeam=1,
                        nserver=32, navg=24, chan0=0, seq=2400 * 3 + 48)
    h, d = decode.pbeam(pk.encode_pbeam(ph, pw))
    assert h == vars(ph) and np.array_equal(d, pw)
    vl = rng.standard_normal((192, 2, 2)).astype(np.float32)
    ih = pk.IBeamHeader(server=1, gbe=0, nchan=192, nbeam=2, nserver=32,
                        chan0=0, seq=2400 * 4 + 7)
    h, d = decode.ibeam(pk.encode_ibeam(ih, vl))
    assert h == vars(ih) and np.array_equal(d, vl)
    with pytest.raises(ValueError):
        decode.ibeam(pk.encode_ibeam(ih, vl)[:-4])


def test_frozen_bounds_at_lwa352_width():
    # one window: 192 channels x 2400 spectra x 704 inputs
    npair = 704 * 705 // 2                       # 248160
    nbyte, nop, kind = roofline.corr_work(192, 2400, 704)
    assert nbyte == 192 * 2400 * 704 + 8 * 192 * npair == 705_576_960
    assert nop == 8 * 192 * 2400 * npair == 914_817_024_000
    assert kind == "int8"
    t, by = roofline.bound_s(nbyte, nop, kind)
    assert by == "operations" and t == pytest.approx(4.6226e-4, rel=1e-4)
    nbyte, nop, kind = roofline.pfb_work(2400, 192, 704, 4, 1)
    assert nbyte == 2403 * 384 * 704 + 704 * 2400 * 192 == 974_020_608
    assert nop == pytest.approx(2400 * 704 * 384 * (8 + 2.5 * 8.584962500721156))
    t, by = roofline.bound_s(nbyte, nop, kind)
    assert by == "bytes" and t == pytest.approx(2.9075e-4, rel=1e-4)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265])
    y = xr.round_tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2 ** -10
    assert y[1] in (1.0, 1.0 + 2 ** -10)
    assert abs(float(y[3]) - 3.14159265) <= 3.14159265 * 2 ** -11
