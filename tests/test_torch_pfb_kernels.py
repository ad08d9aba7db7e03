"""The channelizer kernel (``ops/kernels/csrc/pfb_quantize.cu``) against its
float64 plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU host
without JAX run ``python -m pytest --noconftest
tests/test_torch_pfb_kernels.py``.  Ragged shapes (L = 368, spectra not a
multiple of the block's 3, inputs not a multiple of its 16, one spectrum,
200 channels = two channel passes of the direct kernel, 435 channels = its
one-spectrum blocks), both DFT modes and both precisions, scalar and
per-channel scales, int8 against float32 ADC, a structured ADC (tones and
a ramp, distinct per input), and one production-width case per mode with
the threshold-case count held to 1e-6 of the codes.  Gate: every differing nibble is one step from the
reference at a value within 1e-3 of the rounding threshold, and such
threshold cases are at most 1e-6 of the values (1e-5 in bf16 mode, where
an operand on a bf16 rounding tie may round either way), plus 2.
"""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _adc(dev, nchan, ntap, nspec, ninput, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = ((nspec + ntap - 1) * 2 * nchan, ninput)
    if dtype == "int8":
        return torch.randint(-90, 91, shape, generator=g, device=dev,
                             dtype=torch.int8)
    return torch.randn(shape, generator=g, device=dev) * 40


def _scale(x, w, nchan, ntap, per_chan, seed):
    """A gain that puts the pre-quantization rms near 2.5 codes."""
    re, _ = pfb.pfb_prequant_ref(x[:, :4], w, nchan, ntap, 1.0)
    s = 2.5 / float(re.std())
    if not per_chan:
        return s
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(0.7, 1.3, nchan).astype(np.float32)
                            * np.float32(s)).to(x.device)


def check(got, x, w, nchan, ntap, scale, fast):
    """Gate the kernel's bytes against the plain version; returns the count
    of tolerated threshold cases."""
    assert got.shape == (x.shape[1], x.shape[0] // (2 * nchan) - ntap + 1,
                         nchan)
    tolerated = pfb.assert_packed_matches_ref(got, x, w, nchan, ntap, scale,
                                              fast)
    bound = (1e-5 if fast else 1e-6) * 2 * got.numel() + 2
    assert tolerated <= bound, (tolerated, bound)
    return tolerated


@pytest.mark.parametrize("nchan,nspec,ninput", [
    (184, 13, 130), (192, 5, 33), (16, 9, 70), (4096, 5, 130),
    (2048, 3, 35), (200, 4, 17), (435, 2, 20), (192, 1, 16), (192, 7, 704),
    (184, 5, 48)])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("per_chan", [False, True])
def test_kernel_matches_plain(dev, nchan, nspec, ninput, fast, per_chan):
    ntap = 4
    x = _adc(dev, nchan, ntap, nspec, ninput, "float32", nchan + ninput)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x, w, nchan, ntap, per_chan, nspec)
    fn = (pfb_fused.pfb_direct if pfb._dft_factors(2 * nchan) is None
          else pfb_fused.pfb_factored)
    before = fn.launches
    got = pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, scale, fast)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    check(got, x, w, nchan, ntap, scale, fast)


@pytest.mark.parametrize("nchan", [184, 4096])
@pytest.mark.parametrize("fast", [False, True])
def test_int8_bytes_equal_f32_bytes(dev, nchan, fast):
    ntap = 4
    x8 = _adc(dev, nchan, ntap, 6, 70, "int8", nchan)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x8, w, nchan, ntap, True, 3)
    a = pfb_fused.pfb_quantize_packed(x8, w, nchan, ntap, scale, fast)
    b = pfb_fused.pfb_quantize_packed(x8.float(), w, nchan, ntap, scale,
                                      fast)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_strided_adc_and_single_tap(dev):
    """ADC stored input-major (a transposed view) reads the same samples;
    ntap = 1 is a plain framed DFT."""
    nchan = 192
    x = _adc(dev, nchan, 4, 7, 50, "int8", 5)
    w = torch.from_numpy(pfb.pfb_window(nchan, 4)).to(dev)
    xt = x.T.contiguous().T
    assert xt.stride() != x.stride()
    a = pfb_fused.pfb_quantize_packed(x, w, nchan, 4, 0.3)
    b = pfb_fused.pfb_quantize_packed(xt, w, nchan, 4, 0.3)
    assert torch.equal(a, b)
    w1 = torch.from_numpy(pfb.pfb_window(nchan, 1)).to(dev)
    got = pfb_fused.pfb_quantize_packed(x, w1, nchan, 1, 0.3)
    check(got, x, w1, nchan, 1, 0.3, False)


@pytest.mark.parametrize("fast", [False, True])
def test_structured_adc(dev, fast):
    """Tones in channels 5 and 77 plus a ramp, amplitudes and phases
    distinct per input: a wrong row, lane or channel map shows as a tone in
    the wrong place, not as noise."""
    nchan, ntap, nspec, ninput = 192, 4, 8, 40
    L = 2 * nchan
    t = torch.arange((nspec + ntap - 1) * L, device=dev,
                     dtype=torch.float64)[:, None]
    i = torch.arange(ninput, device=dev, dtype=torch.float64)[None, :]
    x = ((20 + i) * torch.cos(2 * np.pi * 5 * t / L + 0.1 * i)
         + (60 - i) * torch.sin(2 * np.pi * 77 * t / L + 0.3 * i)
         + (t % 17) - 8).round().clamp(-127, 127).to(torch.int8)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = 7.0 / float(pfb.pfb_prequant_ref(x[:, :4], w, nchan, ntap,
                                              1.0)[0].abs().max())
    got = pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, scale, fast)
    torch.cuda.synchronize()
    check(got, x, w, nchan, ntap, scale, fast)
    mag = (got >> 4).to(torch.int8)
    mag = torch.where(mag > 7, mag - 16, mag).abs().float().mean((0, 1))
    assert set(mag.topk(2).indices.tolist()) == {5, 77}


@pytest.mark.parametrize("nchan,nspec,fast", [
    (192, 2400, False), (192, 2400, True), (4096, 24, False)])
def test_production_width(dev, nchan, nspec, fast):
    """704 inputs: one 2400-spectra window at 192 channels (direct) and 24
    spectra of the 4096-channel F-engine (factored), int8 ADC."""
    ntap = 4
    x = _adc(dev, nchan, ntap, nspec, 704, "int8", nchan + nspec)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x, w, nchan, ntap, False, 0)
    got = pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, scale, fast)
    torch.cuda.synchronize()
    check(got, x, w, nchan, ntap, scale, fast)
