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


@pytest.mark.parametrize("nchan", [16, 184, 192, 200])
def test_direct_table_is_the_folded_rdft(nchan):
    """The direct kernel's table, element by element: slab layout [pass,
    k // 8, (cos, -sin), k % 8, c % 192] of rows k <= nchan of
    ``rdft_matrices``; -sin rows 0 and nchan, pad rows and pad channels
    are zero."""
    cos_m, msin_m = pfb.rdft_matrices(nchan)
    t = pfb_fused.direct_table_ref(nchan)
    ks, cp = pfb_fused.DIRECT_KS, pfb_fused.DIRECT_CPASS
    kpad, npad = -(-(nchan + 1) // ks) * ks, -(-nchan // cp) * cp
    assert t.shape == (npad // cp, kpad // ks, 2, ks, cp)
    assert t.dtype == np.float32 and t.flags["C_CONTIGUOUS"]
    flat = t.transpose(2, 1, 3, 0, 4).reshape(2, kpad, npad)
    np.testing.assert_array_equal(flat[0, :nchan + 1, :nchan],
                                  cos_m[:nchan + 1])
    np.testing.assert_array_equal(flat[1, 1:nchan, :nchan], msin_m[1:nchan])
    assert not flat[1, 0].any() and not flat[1, nchan:].any()
    assert not flat[:, nchan + 1:].any() and not flat[:, :, nchan:].any()
    for k, c in [(0, 0), (nchan, nchan - 1), (7, 5), (9, nchan - 3)]:
        want = (cos_m[k, c], msin_m[k, c] if 0 < k < nchan else 0.0)
        got = t[c // cp, k // ks, :, k % ks, c % cp]
        assert tuple(got) == want


@pytest.mark.parametrize("nchan", [16, 192])
def test_fold_ref_and_table_give_the_real_dft(nchan, rng):
    """e . cos and o . (-sin) from the folded rows and table equal the
    float64 product with the full ``rdft_matrices`` to 1e-6 of the
    spectrum's rms (a mirrored table entry may differ by a float32 ulp)."""
    L = 2 * nchan
    fir = torch.from_numpy(rng.randn(5, L).astype(np.float32) * 50)
    e, o = pfb_fused.fold_ref(fir)
    assert e.dtype == torch.float64 and e.shape == (5, nchan + 1)
    x = fir.double()
    assert torch.equal(e[:, 0], x[:, 0]) and torch.equal(e[:, nchan],
                                                         x[:, nchan])
    assert torch.equal(e[:, 3], x[:, 3] + x[:, L - 3])
    assert torch.equal(o[:, 3], x[:, 3] - x[:, L - 3])
    assert not o[:, 0].any() and not o[:, nchan].any()
    cos_m, msin_m = (torch.from_numpy(m).double()
                     for m in pfb.rdft_matrices(nchan))
    t = torch.from_numpy(pfb_fused.direct_table_ref(nchan)).double()
    flat = t.permute(2, 1, 3, 0, 4).reshape(2, -1, t.shape[0] * t.shape[4])
    re = e @ flat[0, :nchan + 1, :nchan]
    im = o @ flat[1, :nchan + 1, :nchan]
    want_re, want_im = x @ cos_m, x @ msin_m
    rms = float(want_re.std())
    assert float((re - want_re).abs().max()) <= 1e-6 * rms
    assert float((im - want_im).abs().max()) <= 1e-6 * rms


def test_direct_shared_bytes_is_what_the_kernel_asks_for():
    """e and o [kpad][16 mt + 4] doubles plus four [2][8][200] float slabs:
    three spectra a block at the production L, one up to L ~ 1130."""
    assert pfb_fused.direct_shared_bytes(384, 3) == 2 * 200 * 52 * 8 + 51200
    assert pfb_fused.direct_shared_bytes(384, 3) <= pfb_fused.MAX_SHARED
    assert pfb_fused.direct_shared_bytes(384) == 2 * 200 * 20 * 8 + 51200
    assert pfb_fused.direct_shared_bytes(870, 3) > pfb_fused.MAX_SHARED
    assert pfb_fused.direct_shared_bytes(870) <= pfb_fused.MAX_SHARED
    assert pfb_fused.direct_shared_bytes(2046) > pfb_fused.MAX_SHARED
