"""The channelizer kernels (``ops/kernels/csrc/pfb_quantize.cu``,
``pfb_fft.cu``) against their float64 plain version, on the card.

Marked ``cuda``: each test skips without a CUDA device.  On a GPU host
without JAX run ``python -m pytest --noconftest
tests/test_torch_pfb_kernels.py``.  Ragged shapes (L = 368, spectra not a
multiple of the block's 3, inputs not a multiple of its 16 or of the FFT
kernel's 32, one spectrum, 200 channels = two channel passes of the direct
kernel, 435 channels = its one-spectrum blocks), every DFT mode (direct,
factored, the FFT at 192 and 96 channels) and both precisions, scalar and
per-channel scales, int8 against float32 ADC, a structured ADC (tones and
a ramp, distinct per input), and one production-width case per mode with
the threshold-case count held to 1e-6 of the codes; at the pipeline width
the FFT kernel's bytes against the direct kernel's on three seeds, and
which kernel each call launches.  Gate: every differing nibble is one step
from the reference at a value within 1e-3 of the rounding threshold, and
such threshold cases are at most 1e-6 of the values (1e-5 in bf16 mode,
where an operand on a bf16 rounding tie may round either way), plus 2.
"""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as C
from caltech_bifrost_dsp_tpu_torch.models import xengine as px
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
    (184, 5, 48), (96, 11, 70)])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("per_chan", [False, True])
def test_kernel_matches_plain(dev, nchan, nspec, ninput, fast, per_chan):
    ntap = 4
    x = _adc(dev, nchan, ntap, nspec, ninput, "float32", nchan + ninput)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x, w, nchan, ntap, per_chan, nspec)
    fn = pfb_fused.kernel_for(x, nchan, ntap, fast)
    before = fn.launches
    got = pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, scale, fast)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    check(got, x, w, nchan, ntap, scale, fast)


@pytest.mark.parametrize("nchan", [184, 4096, 192, 96])
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


@pytest.mark.parametrize("nspec,ninput,dtype,fast,per_chan,strided", [
    (5, 18, "int8", False, False, False), (3, 16, "int8", False, True, False),
    (2, 5, "float32", False, True, True), (4, 32, "int8", True, False, True),
    (1, 3, "float32", True, True, False)])
def test_factored_at_1024_channels(dev, nspec, ninput, dtype, fast, per_chan,
                                   strided):
    """L = 2048 = 64 x 32, the shapes of the g++ emulation test and a few
    more: both DFT stages on the FP64 tensor cores, int8 rows through the
    16-byte FIR kernel (16 and 32 inputs) and through the generic one, a
    strided ADC (every second column of a wider array), both precisions."""
    nchan, ntap = 1024, 4
    wide = _adc(dev, nchan, ntap, nspec, ninput * (2 if strided else 1),
                dtype, nspec + ninput)
    x = wide[:, ::2] if strided else wide
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x, w, nchan, ntap, per_chan, ninput)
    before = pfb_fused.pfb_factored.launches
    got = pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, scale, fast)
    torch.cuda.synchronize()
    assert pfb_fused.pfb_factored.launches == before + 1
    check(got, x, w, nchan, ntap, scale, fast)


def test_lengths_neither_kernel_takes_raise_on_card(dev):
    """On both sides of the direct kernel's limit: nchan = 559 runs, 560
    raises (its folded FIR rows no longer fit shared memory); a factor
    pair the factored kernel does not tile raises too."""
    ntap = 4
    limit = pfb_fused.direct_max_nchan()
    x = _adc(dev, limit, ntap, 2, 3, "int8", 1)
    w = torch.from_numpy(pfb.pfb_window(limit, ntap)).to(dev)
    scale = _scale(x, w, limit, ntap, False, 0)
    got = pfb_fused.pfb_quantize_packed(x, w, limit, ntap, scale)
    torch.cuda.synchronize()
    check(got, x, w, limit, ntap, scale, False)
    for nchan, match in ((limit + 1, "too long for the direct kernel"),
                         (1072, "the factored kernel takes")):
        x = _adc(dev, nchan, ntap, 1, 2, "int8", 2)
        w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
        with pytest.raises(ValueError, match=match):
            pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, 0.01)


@pytest.mark.parametrize("nchan,nspec,fast", [
    (192, 2400, False), (192, 2400, True), (4096, 24, False),
    (4096, 24, True)])
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


@pytest.mark.parametrize("seed", [11, 2147483659, 3000000019])
def test_fft_bytes_against_direct_at_pipeline_width(dev, seed):
    """704 inputs x 2400 spectra x 192 channels of int8 ADC through the
    FFT kernel and the direct kernel: the codes that differ are counted
    (expected near 0: the two differ by their float32 DFT tables and sum
    order) and must be at most 1e-6 of the nibbles, each one step apart at
    a value within 1e-3 of a rounding threshold."""
    nchan, ntap, nspec, ninput = 192, 4, 2400, 704
    x = _adc(dev, nchan, ntap, nspec, ninput, "int8", seed % (1 << 62))
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    scale = _scale(x, w, nchan, ntap, True, seed % (1 << 31))
    got = pfb_fused.pfb_fft(x, w, nchan, ntap, scale)
    direct = pfb_fused.pfb_direct(x, w, nchan, ntap, scale)
    torch.cuda.synchronize()
    tolerated = 0
    for sl, pre, _ in pfb._ref_chunks(x, w, nchan, ntap, scale, False):
        tolerated += pfb.assert_packed_close(got[sl], direct[sl], pre)
    print(f"seed {seed}: {tolerated} of {2 * got.numel()} nibbles differ "
          f"from the direct kernel")
    assert tolerated <= 1e-6 * 2 * got.numel()


def test_which_kernel_each_call_launches(dev):
    """The float32 mode at 192 and 96 channels launches the FFT kernel
    (int8 and float32 ADC); the bf16 mode, a length it is not compiled for
    and an int8 ring past its shared memory launch the direct kernel."""
    def launches(nchan, ntap, fast, dtype):
        x = _adc(dev, nchan, ntap, 2, 40, dtype, nchan)
        w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
        before = (pfb_fused.pfb_fft.launches, pfb_fused.pfb_direct.launches)
        pfb_fused.pfb_quantize_packed(x, w, nchan, ntap, 0.1, fast)
        torch.cuda.synchronize()
        return (pfb_fused.pfb_fft.launches - before[0],
                pfb_fused.pfb_direct.launches - before[1])

    assert launches(192, 4, False, "int8") == (1, 0)
    assert launches(192, 4, False, "float32") == (1, 0)
    assert launches(96, 1, False, "int8") == (1, 0)
    assert launches(192, 4, True, "int8") == (0, 1)
    assert launches(184, 4, False, "int8") == (0, 1)
    assert not pfb_fused.fft_takes(192, 8, torch.int8)
    assert launches(192, 8, False, "int8") == (0, 1)
    assert launches(192, 8, False, "float32") == (1, 0)


def test_fx_step_at_pipeline_width_launches_the_fft_kernel(dev):
    """One FX window at the pipeline's 192 channels and 704 inputs: the
    channelizer is the FFT kernel alone."""
    cfg = C.LWA352.replace(ntime_gulp=48, acc_len=48, acc_len_slow=96,
                           adc_dtype="int8")
    _, _, gains, pairs = px.default_inputs(cfg, device=dev)
    x = _adc(dev, cfg.nchan, cfg.pfb_ntap, cfg.ntime_gulp, cfg.ninput,
             "int8", 7)
    w = torch.from_numpy(pfb.pfb_window(cfg.nchan, cfg.pfb_ntap)).to(dev)
    before = (pfb_fused.pfb_fft.launches, pfb_fused.pfb_direct.launches,
              pfb_fused.pfb_factored.launches)
    px.fx_step(px.init_state(cfg, dev), x, w, 1.0, gains, pairs, True, True,
               True, cfg)
    torch.cuda.synchronize()
    assert (pfb_fused.pfb_fft.launches - before[0],
            pfb_fused.pfb_direct.launches - before[1],
            pfb_fused.pfb_factored.launches - before[2]) == (1, 0, 0)
