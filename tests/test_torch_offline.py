"""The port's offline pipelines (``models/offline.py``, ``ops/pfb.py::
upchannelize``, ``utils/skycoords.py``) against the JAX package's on the
CPU, at ``tests/test_offline.py``'s shapes.

Tolerances: sky coordinates, weights and DFT tables bit-equal; the fine
channels at nup 8 within rtol 1e-5, atol 1e-5 x max (float32 FFTs in two
libraries), at nup 2 exact (a sum and a difference of small integers);
beams within rtol 1e-4, atol 1e-4 x max; visibilities at nup 2 exact, at
nup 8 within 1e-5 x max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.models import offline as joff
from caltech_bifrost_dsp_tpu.ops import pfb as jpfb
from caltech_bifrost_dsp_tpu.utils import skycoords as jsky
from caltech_bifrost_dsp_tpu.utils.codec import pack_np, unpack_complex_np
from caltech_bifrost_dsp_tpu_torch.models import offline
from caltech_bifrost_dsp_tpu_torch.ops import pfb
from caltech_bifrost_dsp_tpu_torch.utils import skycoords

torch.set_num_threads(1)

NTIME, NCHAN, NSTAND, NPOL, NUP = 128, 4, 6, 2, 8
T_UNIX = 1.7e9


def packed_voltages(seed, ntime=NTIME):
    rng = np.random.RandomState(seed)
    re = rng.randint(-8, 8, [ntime, NCHAN, NSTAND, NPOL])
    im = rng.randint(-8, 8, [ntime, NCHAN, NSTAND, NPOL])
    return pack_np(re, im)


def beam_cfgs(seed, nbeam=2, nup=NUP, ntimestep=1000, cal=False,
              taper=False):
    """The same pointing for both packages (each its own dataclass)."""
    rng = np.random.RandomState(seed)
    kw = dict(nbeam=nbeam, ra_deg=[10.0 * b for b in range(nbeam)],
              dec_deg=[30.0 + b for b in range(nbeam)],
              enz_positions=rng.standard_normal([NSTAND, 3]) * 100,
              nupchan=nup, ntimestep=ntimestep)
    if cal:
        shape = (NCHAN * nup, NSTAND * NPOL)
        kw["cal_gains"] = (rng.standard_normal(shape)
                           + 1j * rng.standard_normal(shape))
    if taper:
        kw["weighting"] = rng.uniform(-0.5, 1.5, NSTAND)
    return joff.OfflineBeamConfig(**kw), offline.OfflineBeamConfig(**kw)


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def voltages(packed):
    return unpack_complex_np(packed).astype(np.complex64)


@pytest.mark.parametrize("ra, dec, t, lat, lon", [
    (0.0, 37.0, 0.0, 37.2398, -118.2817),
    (37.95, 89.26, T_UNIX, 37.24, -118.28),
    (123.4, -20.5, T_UNIX + 4321.25, -30.7, 21.4),
    (359.9, 0.0, 1.8e9 + 0.125, 37.2398, -118.2817),
])
def test_skycoords_bit_equal(ra, dec, t, lat, lon):
    assert skycoords.unix_to_jd(t) == jsky.unix_to_jd(t)
    assert skycoords.gmst_deg(t) == jsky.gmst_deg(t)
    az, alt = skycoords.radec_to_altaz(ra, dec, t, lat, lon)
    assert (az, alt) == jsky.radec_to_altaz(ra, dec, t, lat, lon)
    np.testing.assert_array_equal(skycoords.pointing_to_direction(az, alt),
                                  jsky.pointing_to_direction(az, alt))
    enz = np.random.RandomState(3).standard_normal([NSTAND, 3]) * 100
    np.testing.assert_array_equal(skycoords.geometric_delays_s(enz, az, alt),
                                  jsky.geometric_delays_s(enz, az, alt))


@pytest.mark.parametrize("cal, taper", [(False, False), (True, False),
                                        (False, True), (True, True)])
def test_compute_offline_weights_bit_equal(cal, taper):
    jcfg, cfg = beam_cfgs(11, nbeam=3, cal=cal, taper=taper)
    freqs = 50e6 + np.arange(NCHAN * NUP) * 3.1e3
    want = joff.compute_offline_weights(jcfg, freqs, T_UNIX)
    got = offline.compute_offline_weights(cfg, freqs, T_UNIX)
    assert got.dtype == np.complex64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 8, 32])
def test_cdft_matrices_bit_equal(n):
    for got, want in zip(pfb.cdft_matrices(n), jpfb.cdft_matrices(n)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nup", [2, 8])
@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
def test_upchannelize_matches_jax(nup, fft_impl):
    v = voltages(packed_voltages(5))
    want = np.asarray(jpfb.upchannelize(jnp.asarray(v), nup,
                                        fft_impl=fft_impl))
    got = pfb.upchannelize(torch.from_numpy(v), nup, fft_impl=fft_impl)
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == want.shape == (NTIME // nup, nup, NCHAN,
                                              NSTAND, NPOL)
    if nup == 2:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        close(got.numpy(), want, 1e-5)


def test_upchannelize_time_axis_and_length():
    v = voltages(packed_voltages(6))
    vt = np.moveaxis(v, 0, 2)                       # time on axis 2
    want = np.asarray(jpfb.upchannelize(jnp.asarray(vt), 4, axis_time=2))
    got = pfb.upchannelize(torch.from_numpy(vt), 4, axis_time=2)
    close(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="multiple of nup"):
        pfb.upchannelize(torch.from_numpy(v[:12]), 8)


def test_gulp_functions_match_jax():
    v = voltages(packed_voltages(7))
    jfine = joff.upchannelize_gulp(jnp.asarray(v), NUP)
    fine = offline.upchannelize_gulp(torch.from_numpy(v), NUP)
    assert fine.is_contiguous()
    close(fine.numpy(), jfine, 1e-5)
    jcfg, cfg = beam_cfgs(8)
    freqs = 50e6 + np.arange(NCHAN * NUP) * 3.1e3
    w = offline.compute_offline_weights(cfg, freqs, T_UNIX)
    want = joff.apply_weights_and_sum(jfine, jnp.asarray(w))
    got = offline.apply_weights_and_sum(fine, torch.from_numpy(w))
    close(got.numpy(), want, 1e-4)
    jsel = joff.upchan_select_gulp(jnp.asarray(v), NUP, 4, 12)
    sel = offline.upchan_select_gulp(torch.from_numpy(v), NUP, 4, 12)
    close(sel.numpy(), jsel, 1e-5)
    want = joff.correlate_offline(jsel)
    got = offline.correlate_offline(sel)
    close(got.numpy(), want, 1e-5)
    acc = got.clone()
    assert offline.correlate_offline(sel, acc) is acc
    close(acc.numpy(), 2 * np.asarray(want), 1e-5)


@pytest.mark.parametrize("accumulate", [True, False])
@pytest.mark.parametrize("gulp, ntimestep", [(64, 1000), (16, 40)])
def test_upchan_beamform_run_matches_jax(accumulate, gulp, ntimestep):
    """(16, 40): the weights are recomputed at samples 48 and 96."""
    packed = packed_voltages(9)
    jcfg, cfg = beam_cfgs(10, ntimestep=ntimestep)
    jfreqs, want = joff.upchan_beamform_run(
        packed, jcfg, 50e6, 25e3, t_unix=T_UNIX, gulp_ntime=gulp,
        accumulate=accumulate)
    freqs, got = offline.upchan_beamform_run(
        packed, cfg, 50e6, 25e3, t_unix=T_UNIX, gulp_ntime=gulp,
        accumulate=accumulate, device="cpu")
    np.testing.assert_array_equal(freqs, jfreqs)
    assert len(got) == len(want) == NTIME // gulp
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        assert g.dtype == w.dtype
        close(g, w, 1e-4)


def test_beamform_run_recomputes_the_weights():
    """The weights of a late gulp are those of its recompute time: a run
    with them matches, one with the start's does not."""
    packed = packed_voltages(12)
    _, cfg = beam_cfgs(13, ntimestep=40)
    freqs, got = offline.upchan_beamform_run(
        packed, cfg, 50e6, 25e3, t_unix=T_UNIX, gulp_ntime=16,
        accumulate=False, device="cpu")
    fine = offline.upchannelize_gulp(
        torch.from_numpy(voltages(packed[96:112])), NUP)
    for t, ok in ((T_UNIX + 96 / 25e3, True), (T_UNIX, False)):
        w = torch.from_numpy(offline.compute_offline_weights(cfg, freqs, t))
        beams = offline.apply_weights_and_sum(fine, w).numpy()
        assert np.array_equal(beams, got[6]) == ok


@pytest.mark.parametrize("nup, chan_range, nframe, gulp", [
    (2, (0, 8), 32, 64),       # 128 frames -> 4 integrations
    (2, (3, 7), 40, 32),       # 32, 32, 32, 32 frames: closes at 48, 96
    (8, (4, 12), 8, 64),       # test_offline.py's run
    (8, (0, 32), 24, 64),      # a partial last integration (16 frames)
])
def test_upchan_imaging_run_matches_jax(nup, chan_range, nframe, gulp):
    packed = packed_voltages(14)
    want = joff.upchan_imaging_run(packed, nup, chan_range, nframe, gulp)
    got = offline.upchan_imaging_run(packed, nup, chan_range, nframe, gulp,
                                     device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.dtype == np.complex64
        assert g.shape == w.shape
        if nup == 2:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_offline_runs_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    packed = packed_voltages(15)
    _, cfg = beam_cfgs(16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.upchan_beamform_run(packed, cfg, 50e6, 25e3, gulp_ntime=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        offline.upchan_imaging_run(packed, 2, (0, 8), 32, 64)


def test_full_fp32_matmul_restores_the_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pfb.full_fp32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
