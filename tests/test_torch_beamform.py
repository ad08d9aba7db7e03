"""Port beamformer (plain path, as the kernel wrapper runs it on CPU) vs
the JAX package.  Tolerance for beam products: rtol 1e-4 with atol 1e-4 *
max|ref| (the reference's gate; fp32 sums run in another order and the XY
cross terms cancel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops import beamform as jbf
from caltech_bifrost_dsp_tpu.ops.pallas.beamform_fused import (
    beamform_products_pallas, stacked_gains)
from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.verification import golden

torch.set_num_threads(1)


def close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _inputs(seed, ntime, nchan, ni, nbeam):
    rng = np.random.RandomState(seed)
    packed = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
    gr = rng.randn(nchan, nbeam, ni).astype(np.float32)
    gi = rng.randn(nchan, nbeam, ni).astype(np.float32)
    return packed, gr, gi


def _gains(gr, gi):
    return (bf.BeamGains(torch.from_numpy(gr), torch.from_numpy(gi)),
            jbf.BeamGains(jnp.asarray(gr), jnp.asarray(gi)))


# (ntime, nchan, ninput, nbeam, ntime_sum): TINY, CPU_REF, ragged
SHAPES = [(48, 16, 32, 4, 12), (120, 64, 32, 8, 24), (48, 8, 72, 4, 12)]


@pytest.mark.parametrize("shape", SHAPES)
def test_beamform_gulp_and_products_match_jax(shape):
    ntime, nchan, ni, nbeam, ntime_sum = shape
    packed, gr, gi = _inputs(1, ntime, nchan, ni, nbeam)
    tg, jg = _gains(gr, gi)
    jv = jbf.beamform_gulp(jnp.asarray(packed), jg)
    tv = bf.beamform_gulp(torch.from_numpy(packed), tg)
    close(tv.real, jv.real)
    close(tv.imag, jv.imag)
    close(bf.beam_power_sum(tv, ntime_sum),
          jbf.beam_power_sum(jv, ntime_sum))
    close(bf.beam_power_single(tv, 1, ntime_sum),
          jbf.beam_power_single(jv, 1, ntime_sum))
    close(bf.vlbi_voltage_select(tv), jbf.vlbi_voltage_select(jv))


@pytest.mark.parametrize("layout", ["tci", "cti"])
@pytest.mark.parametrize("shape", SHAPES)
def test_beamform_products_matches_pallas_kernel(shape, layout):
    """Against ``beamform_products_pallas`` in interpret mode, at the
    256-padded gain width the JAX step uses; cti pad lanes hold garbage."""
    ntime, nchan, ni, nbeam, ntime_sum = shape
    packed, gr, gi = _inputs(2, ntime, nchan, ni, nbeam)
    tg, jg = _gains(gr, gi)
    if layout == "cti":
        staged = np.full((nchan, ntime, 256), 0x77, np.uint8)
        staged[:, :, :ni] = packed.transpose(1, 0, 2)
    else:
        staged = packed
    jp, jv = beamform_products_pallas(jnp.asarray(staged),
                                      stacked_gains(jg, 256), ntime_sum,
                                      layout=layout, interpret=True)
    tp, tv = bf.beamform_products(torch.from_numpy(staged), tg, ntime_sum,
                                  layout=layout)
    close(tp, jp)
    close(tv, jv)


@pytest.mark.parametrize("want_power,want_vlbi", [(True, False),
                                                  (False, True),
                                                  (False, False)])
def test_beamform_products_skips_unwanted(want_power, want_vlbi):
    packed, gr, gi = _inputs(3, 24, 2, 8, 2)
    tg, _ = _gains(gr, gi)
    p, v = bf.beamform_products(torch.from_numpy(packed), tg, 12,
                                want_power, want_vlbi)
    assert (p is not None) == want_power
    assert (v is not None) == want_vlbi


def test_beam_products_vs_float64_truth_with_cancellation():
    """Y beams nearly equal to X beams times i: Re(XY*) cancels to ~0
    while XX is large -- the case that exposed a one-pass bf16
    integration on the TPU."""
    ntime, nchan, ni, nbeam, ntime_sum = 48, 4, 40, 4, 24
    packed, gr, gi = _inputs(4, ntime, nchan, ni, nbeam)
    rng = np.random.RandomState(5)
    gr[:, 1::2] = -gi[:, 0::2] + 1e-3 * rng.randn(nchan, nbeam // 2, ni)
    gi[:, 1::2] = gr[:, 0::2] + 1e-3 * rng.randn(nchan, nbeam // 2, ni)
    tg, _ = _gains(gr, gi)
    power, vlbi = bf.beamform_products(torch.from_numpy(packed), tg,
                                       ntime_sum)
    block = packed.reshape(ntime, nchan, ni // 2, 2)
    br, bi = golden.host_beams(block, gr, gi)
    close(power, golden.host_power(br, bi, ntime_sum))
    want_v = np.stack([br[:, :2], bi[:, :2]], axis=-1).transpose(2, 0, 1, 3)
    close(vlbi, want_v)


def test_integer_gains_give_exact_vlbi():
    ntime, nchan, ni, nbeam = 48, 3, 36, 4
    rng = np.random.RandomState(6)
    packed = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
    gr = rng.randint(-8, 9, (nchan, nbeam, ni)).astype(np.float32)
    gi = rng.randint(-8, 9, (nchan, nbeam, ni)).astype(np.float32)
    tg, _ = _gains(gr, gi)
    _, vlbi = bf.beamform_products(torch.from_numpy(packed), tg, 12)
    br, bi = golden.host_beams(packed.reshape(ntime, nchan, ni // 2, 2),
                               gr, gi)
    want = np.stack([br[:, :2], bi[:, :2]], axis=-1).transpose(2, 0, 1, 3)
    np.testing.assert_array_equal(vlbi.numpy(), want.astype(np.float32))


def test_gain_helpers_match_jax():
    rng = np.random.RandomState(7)
    nchan, nbeam, ni = 3, 4, 6
    freqs = 1e6 * (50 + np.arange(nchan))
    delays = rng.uniform(-100, 100, (nbeam, ni))
    amps = rng.uniform(0.5, 1.5, (nbeam, ni))
    cal = (rng.randn(nchan, nbeam, ni)
           + 1j * rng.randn(nchan, nbeam, ni)).astype(np.complex64)
    want = jbf.delays_to_gains(freqs, delays, amps, cal)
    got = bf.delays_to_gains(freqs, delays, amps, cal)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))
    g = bf.BeamGains.from_complex(cal)
    np.testing.assert_array_equal(g.imag.numpy(), np.imag(cal))
