"""Which channelizer lengths the CUDA kernels take, computed from the
shared-memory formulas the wrappers use (no card needed: the checks run
before any launch).  The CPU path answers every length."""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused


def test_direct_limit_follows_from_the_shared_memory_formula():
    limit = pfb_fused.direct_max_nchan()
    assert pfb_fused.direct_shared_bytes(2 * limit) <= pfb_fused.MAX_SHARED
    assert pfb_fused.direct_shared_bytes(2 * (limit + 1)) \
        > pfb_fused.MAX_SHARED
    assert limit == 559
    # one spectrum a block is the smallest tile; three need more
    assert pfb_fused.direct_shared_bytes(2 * limit, pfb_fused.DIRECT_MT) \
        > pfb_fused.direct_shared_bytes(2 * limit)
    # the pipeline scale fits with three spectra a block
    assert pfb_fused.direct_shared_bytes(384, pfb_fused.DIRECT_MT) \
        <= pfb_fused.MAX_SHARED


@pytest.mark.parametrize("nchan", [560, 800, 1023])
def test_direct_refuses_lengths_past_the_limit_before_any_launch(nchan):
    assert pfb._dft_factors(2 * nchan) is None
    x = torch.zeros((4 * 2 * nchan, 2), dtype=torch.int8)
    w = pfb.pfb_window(nchan, 4)
    with pytest.raises(ValueError, match="too long for the direct kernel"):
        pfb_fused.pfb_direct(x, w, nchan, 4, 1.0)


@pytest.mark.parametrize("nchan", [560, 1023])
def test_cpu_path_answers_lengths_the_kernels_refuse(nchan):
    rng = np.random.RandomState(nchan)
    x = torch.from_numpy(rng.randint(-90, 91, (5 * 2 * nchan, 2))
                         .astype(np.int8))
    w = torch.from_numpy(pfb.pfb_window(nchan, 4))
    out = pfb_fused.pfb_quantize_packed(x, w, nchan, 4, 0.01)
    assert out.shape == (2, 2, nchan) and out.dtype == torch.uint8


@pytest.mark.parametrize("nchan,ok", [(1024, True), (4096, True),
                                      (2048, True), (1536, True),
                                      (1072, False), (16384, False)])
def test_factored_limit(nchan, ok):
    """(L1, L2) must tile (L1 % 16 == 0, L2 % 8 == 0) and one row must fit
    shared memory; the wrapper refuses the others before any launch (and
    a CPU tensor always, since it launches a CUDA kernel)."""
    L1, L2 = pfb._dft_factors(2 * nchan)
    fits = (L1 % 16 == 0 and L2 % 8 == 0 and
            pfb_fused.factored_shared_bytes(L1, L2) <= pfb_fused.MAX_SHARED)
    assert fits == ok
    x = torch.zeros((4 * 2 * nchan, 1), dtype=torch.int8)
    w = pfb.pfb_window(nchan, 4)
    match = "launches a CUDA kernel" if ok else "the factored kernel takes"
    with pytest.raises(ValueError, match=match):
        pfb_fused.pfb_factored(x, w, nchan, 4, 1.0)


def test_factored_tables_hold_the_half_spectrum():
    """The mirrored inner table against the full one: column pairs are
    (cos, sin) of k2 < L2/2, the two real bins share pair 0."""
    nchan = 1024
    (c2, s2, *_), (L1, L2) = pfb._rdft_factored_tables(nchan)
    half, tw, outer = pfb_fused.factored_tables_ref(nchan)
    full, _, _ = pfb_fused.factored_tables_ref(nchan, half=False)
    assert half.shape == (L2, L2) and full.shape == (L2, 2 * L2)
    assert tw.shape == (L1, L2, 2) and outer.shape == (2, L1, L1 // 2)
    np.testing.assert_array_equal(half[:, 2::2], c2[:, 1:L2 // 2])
    np.testing.assert_array_equal(half[:, 3::2], s2[:, 1:L2 // 2])
    np.testing.assert_array_equal(half[:, 0], c2[:, 0])
    np.testing.assert_array_equal(half[:, 1], c2[:, L2 // 2])
    np.testing.assert_array_equal(full[:, 0::2], c2)
    np.testing.assert_array_equal(full[:, 1::2], s2)
    # what the mirror relies on: the tables are mirror images but for
    # entries that are zero to rounding
    k = np.arange(1, L2)
    assert np.abs(c2[:, k] - c2[:, L2 - k]).max() < 1e-12
    assert np.abs(s2[:, k] + s2[:, L2 - k]).max() < 1e-12


@pytest.mark.parametrize("nchan,ntap,dtype,ok", [
    (192, 4, torch.int8, True), (192, 5, torch.int8, True),
    (192, 6, torch.int8, False), (192, 6, torch.float32, True),
    (96, 4, torch.int8, True), (96, 1, torch.float32, True),
    (184, 4, torch.int8, False), (128, 4, torch.float32, False),
    (1024, 4, torch.int8, False)])
def test_fft_limit_and_the_kernel_each_call_takes(nchan, ntap, dtype, ok):
    """The FFT kernel takes the float32 mode at the channel counts it is
    compiled for while its shared memory (the int8 ring grows with ntap)
    fits; the bf16 mode, and every other length below L = 2048, takes the
    direct kernel, and a factor pair the factored one."""
    fits = pfb_fused.fft_shared_bytes(nchan, ntap, dtype == torch.int8) \
        <= pfb_fused.MAX_SHARED
    assert pfb_fused.fft_takes(nchan, ntap, dtype) == (
        ok and fits and nchan in pfb_fused.FFT_NCHAN)
    x = torch.zeros((4, 2), dtype=dtype)
    want = (pfb_fused.pfb_factored if pfb._dft_factors(2 * nchan)
            else pfb_fused.pfb_fft if ok else pfb_fused.pfb_direct)
    assert pfb_fused.kernel_for(x, nchan, ntap, False) is want
    if want is not pfb_fused.pfb_factored:
        assert pfb_fused.kernel_for(x, nchan, ntap, True) \
            is pfb_fused.pfb_direct


def test_fft_shared_memory_at_the_pipeline_shape():
    """216 064 bytes at nchan 192, ntap 4 with the int8 ring: one block an
    SM; without the ring (float32 ADC) the ring's 86 912 bytes go."""
    assert pfb_fused.fft_shared_bytes(192, 4) == 216064
    assert pfb_fused.fft_shared_bytes(192, 4, ring=False) == 216064 - 86912
    assert 2 * pfb_fused.fft_shared_bytes(192, 4) > pfb_fused.MAX_SHARED


def test_fft_refuses_before_any_launch():
    """The bf16 mode, a length it is not compiled for and a CPU tensor
    raise before the kernel library is asked for."""
    w = pfb.pfb_window(192, 4)
    x = torch.zeros((5 * 384, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="float32 mode only"):
        pfb_fused.pfb_fft(x, w, 192, 4, 1.0, fast=True)
    with pytest.raises(ValueError, match="the FFT kernel takes nchan"):
        pfb_fused.pfb_fft(torch.zeros((5 * 368, 2), dtype=torch.int8),
                          pfb.pfb_window(184, 4), 184, 4, 1.0)
    with pytest.raises(ValueError, match="launches a CUDA kernel"):
        pfb_fused.pfb_fft(x, w, 192, 4, 1.0)


def test_fft_twiddles_are_the_unit_roots():
    """Entry [j, a] is W_L^(j a) for the eight lanes and a <= M / 2; the
    last column holds W_16^j, the real bin M / 2's twiddle."""
    tw = pfb_fused.fft_twiddles_ref(192)
    assert tw.shape == (8, 25, 2) and tw.dtype == np.float64
    j, a = np.meshgrid(np.arange(8), np.arange(25), indexing="ij")
    want = np.exp(-2j * np.pi * j * a / 384)
    np.testing.assert_allclose(tw[..., 0] + 1j * tw[..., 1], want,
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(tw[:, 24, 0] + 1j * tw[:, 24, 1],
                               np.exp(-2j * np.pi * np.arange(8) / 16),
                               rtol=0, atol=1e-15)


def test_phase_probe_finds_the_loops_it_cuts():
    """``scripts/probe_pfb_phases.py`` cuts loops of both channelizer
    sources by their text: every text is still in its source, and every
    variant sets one macro per cut."""
    from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
    from caltech_bifrost_dsp_tpu_torch.scripts import probe_pfb_phases

    for source, launcher, variants, cuts in \
            probe_pfb_phases.KERNELS.values():
        text = (_build.CSRC / source).read_text()
        assert launcher in _build.SIGNATURES
        assert all(cut in text for cut in cuts)
        assert all(len(flags) == len(cuts) for flags in variants.values())
