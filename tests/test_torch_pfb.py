"""The port's channelizer (``caltech_bifrost_dsp_tpu_torch/ops/pfb.py`` and
``pfb_fused.py``, plain versions) vs the JAX ``ops/pfb.py`` and the Pallas
kernel in interpret mode.

The numpy helpers must return JAX's arrays bit for bit.  Packed bytes go
through ``assert_packed_close``, which tolerates a one-step nibble
difference only where the float64 pre-quantization value lies within 1e-3
of a rounding threshold; at these seeds it must count 0, i.e. the bytes
are exact.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops import pfb as jpfb
from caltech_bifrost_dsp_tpu.ops.pallas.pfb_fused import \
    pfb_quantize_packed_pallas
from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused

torch.set_num_threads(1)


def adc(seed, nchan, ntap, nspec, ninput, dtype):
    rng = np.random.RandomState(seed)
    shape = ((nspec + ntap - 1) * 2 * nchan, ninput)
    if dtype == "int8":
        return rng.randint(-100, 100, shape).astype(np.int8)
    return (rng.standard_normal(shape) * 3).astype(np.float32)


def jax_xla(x, w, nchan, ntap, scale):
    re, im = jpfb.pfb_channelize_planes_imajor(
        jnp.asarray(x, jnp.float32), jnp.asarray(w), nchan, ntap)
    return np.asarray(jpfb.quantize_pack_imajor(re, im, jnp.asarray(scale)))


def jax_pallas(x, w, nchan, ntap, scale, fast):
    return np.asarray(pfb_quantize_packed_pallas(
        jnp.asarray(x), jnp.asarray(w), nchan, ntap, jnp.asarray(scale),
        fast=fast, interpret=True))


def port(x, w, nchan, ntap, scale, fast):
    xt = torch.from_numpy(x)
    got = pfb_fused.pfb_quantize_packed(xt, torch.from_numpy(w), nchan,
                                        ntap, scale, fast)
    pre = pfb.pfb_prequant_ref(xt, w, nchan, ntap, scale, fast)
    return got, pre


@pytest.mark.parametrize("kind", ["hamming", "hanning", "boxcar"])
def test_window_matches_jax(kind):
    for nchan, ntap in [(16, 4), (192, 4), (184, 2), (4096, 4)]:
        np.testing.assert_array_equal(pfb.pfb_window(nchan, ntap, kind),
                                      jpfb.pfb_window(nchan, ntap, kind))
    with pytest.raises(ValueError):
        pfb.pfb_window(16, 4, "kaiser")


def test_tables_and_factors_match_jax():
    for nchan in (16, 184, 192):
        for a, b in zip(pfb.rdft_matrices(nchan), jpfb.rdft_matrices(nchan)):
            np.testing.assert_array_equal(a, b)
    for L in (32, 368, 384, 2048, 2050, 4096, 8192, 16384):
        assert pfb._dft_factors(L) == jpfb._dft_factors(L)
    assert pfb._dft_factors(8192) == (128, 64)
    got, gf = pfb._rdft_factored_tables(4096)
    want, wf = jpfb._rdft_factored_tables(4096)
    assert gf == wf
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert pfb.required_ntime(48, 192, 4) == jpfb.required_ntime(48, 192, 4)


def test_reference_np_matches_jax(rng):
    x = rng.standard_normal([(5 + 3) * 32, 3]).astype(np.float32)
    w = pfb.pfb_window(16, 4)
    np.testing.assert_array_equal(pfb.pfb_reference_np(x, w, 16, 4),
                                  jpfb.pfb_reference_np(x, w, 16, 4))


def test_gate_tolerates_only_threshold_steps():
    """A planted one-step difference at a value 2e-4 from the 2.5
    threshold is tolerated; the same difference far from a threshold, or
    two steps at a threshold, is not."""
    pre_re = torch.tensor([[2.5002, 1.1, -7.4999]], dtype=torch.float64)
    pre_im = torch.tensor([[0.2, -3.0, 6.4]], dtype=torch.float64)
    want = pfb.pack(pfb.quantize_nibbles(pre_re), pfb.quantize_nibbles(pre_im))
    got = want.clone()
    got[0, 0] = pfb.pack(torch.tensor(2), torch.tensor(0))   # 3 -> 2
    got[0, 2] = pfb.pack(torch.tensor(-8), torch.tensor(6))  # -7 -> -8
    assert pfb.packed_mismatches(got, want, pre_re, pre_im) == (2, 0)
    assert pfb.assert_packed_close(got, want, (pre_re, pre_im)) == 2
    far = want.clone()
    far[0, 1] = pfb.pack(torch.tensor(2), torch.tensor(-3))  # 1 -> 2
    assert pfb.packed_mismatches(far, want, pre_re, pre_im) == (0, 1)
    with pytest.raises(AssertionError, match="1 packed nibbles"):
        pfb.assert_packed_close(far, want, (pre_re, pre_im))
    two = want.clone()
    two[0, 0] = pfb.pack(torch.tensor(1), torch.tensor(0))   # 3 -> 1
    assert pfb.packed_mismatches(two, want, pre_re, pre_im) == (0, 1)
    assert pfb.packed_mismatches(want, want, pre_re, pre_im) == (0, 0)


def test_quantize_pack_matches_jax_with_ties():
    """Half-integer values round to even in both, per-channel scale on the
    last axis, saturation at -8 and 7."""
    rng = np.random.RandomState(3)
    re = rng.uniform(-10, 10, (3, 5, 8)).astype(np.float32)
    im = rng.uniform(-10, 10, (3, 5, 8)).astype(np.float32)
    re[0, 0, :] = [-8.5, -7.5, -2.5, -0.5, 0.5, 1.5, 2.5, 7.5]
    sc = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    for scale in (np.float32(1.0), sc):
        want = np.asarray(jpfb.quantize_pack_imajor(
            jnp.asarray(re), jnp.asarray(im), jnp.asarray(scale)))
        got = pfb.quantize_pack_imajor(torch.from_numpy(re),
                                       torch.from_numpy(im), scale)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            pfb.quantize_4bit_planes_imajor(torch.from_numpy(re),
                                            torch.from_numpy(im),
                                            scale).numpy(),
            np.asarray(jpfb.quantize_4bit_planes_imajor(
                jnp.asarray(re), jnp.asarray(im), jnp.asarray(scale))))


# (nchan, ninput, nspec, dtype, per-channel scale)
HIGH_CASES = [(192, 16, 48, "float32", False), (192, 64, 48, "int8", True),
              (4096, 2, 8, "float32", False), (4096, 2, 8, "int8", True)]


@pytest.mark.parametrize("nchan,ninput,nspec,dtype,per_chan", HIGH_CASES)
def test_plain_channelizer_matches_jax_exactly(nchan, ninput, nspec, dtype,
                                               per_chan):
    """precision "high": bytes equal JAX's XLA path and the interpret-mode
    Pallas kernel, with 0 tolerated threshold cases."""
    ntap = 4
    x = adc(nchan + ninput, nchan, ntap, nspec, ninput, dtype)
    w = pfb.pfb_window(nchan, ntap)
    scale = (np.random.RandomState(1).uniform(0.3, 0.7, nchan)
             .astype(np.float32) if per_chan else np.float32(0.5))
    if dtype == "int8":
        scale = scale * np.float32(0.05)
    got, pre = port(x, w, nchan, ntap, scale, False)
    assert got.dtype == torch.uint8
    assert got.shape == (ninput, nspec, nchan)
    for want in (jax_xla(x, w, nchan, ntap, scale),
                 jax_pallas(x, w, nchan, ntap, scale, False)):
        assert pfb.assert_packed_close(got, torch.from_numpy(want), pre) == 0


@pytest.mark.parametrize("nchan,ninput,nspec,dtype", [
    (192, 16, 48, "float32"), (192, 32, 24, "int8"), (4096, 2, 8, "float32")])
def test_plain_bf16_matches_pallas_fast(nchan, ninput, nspec, dtype):
    """precision "bf16": operands rounded where the Pallas kernel casts
    (fast=True), direct and factored, exact bytes."""
    ntap = 4
    x = adc(nchan + 7, nchan, ntap, nspec, ninput, dtype)
    w = pfb.pfb_window(nchan, ntap)
    scale = np.float32(0.5 if dtype == "float32" else 0.03)
    got, pre = port(x, w, nchan, ntap, scale, True)
    want = jax_pallas(x, w, nchan, ntap, scale, True)
    assert pfb.assert_packed_close(got, torch.from_numpy(want), pre) == 0


def test_int8_equals_f32_and_dispatch():
    nchan, ntap = 184, 4
    x8 = adc(5, nchan, ntap, 9, 6, "int8")
    w = pfb.pfb_window(nchan, ntap)
    cfg = SimpleNamespace(nchan=nchan, pfb_ntap=ntap, pfb_precision="high")
    for fast in (False, True):
        a = pfb_fused.pfb_quantize_packed(torch.from_numpy(x8), w, nchan,
                                          ntap, 0.04, fast)
        b = pfb_fused.pfb_quantize_packed(
            torch.from_numpy(x8.astype(np.float32)), w, nchan, ntap, 0.04,
            fast)
        assert torch.equal(a, b)
    got = pfb.channelize_pack_imajor(torch.from_numpy(x8), w, cfg, 0.04)
    assert torch.equal(got, pfb.pfb_quantize_packed_ref(
        torch.from_numpy(x8), w, nchan, ntap, 0.04))
    assert not torch.equal(got, a)      # a: the bf16 bytes
    # strided (input-major) storage reads the same samples
    xt = torch.from_numpy(np.ascontiguousarray(x8.T)).T
    assert torch.equal(pfb.channelize_pack_imajor(xt, w, cfg, 0.04), got)


def test_rejects_bad_inputs():
    w = pfb.pfb_window(16, 4)
    good = torch.zeros((7 * 32, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        pfb_fused.pfb_quantize_packed(good.double(), w, 16, 4, 1.0)
    with pytest.raises(ValueError, match="multiple"):
        pfb_fused.pfb_quantize_packed(good[:-1], w, 16, 4, 1.0)
    with pytest.raises(ValueError, match="one spectrum"):
        pfb_fused.pfb_quantize_packed(good[:96], w, 16, 4, 1.0)
    with pytest.raises(ValueError, match="window"):
        pfb_fused.pfb_quantize_packed(good, w[:3], 16, 4, 1.0)
    with pytest.raises(ValueError, match="scale"):
        pfb_fused.pfb_quantize_packed(good, w, 16, 4, np.ones(5))
    with pytest.raises(ValueError, match="precision"):
        pfb.pfb_channelize_planes_imajor(good, w, 16, 4, precision="low")
    with pytest.raises(ValueError, match="CUDA"):
        pfb_fused.pfb_direct(good, w, 16, 4, 1.0)
    with pytest.raises(ValueError, match="factored"):
        pfb_fused.pfb_factored(good, w, 16, 4, 1.0)
