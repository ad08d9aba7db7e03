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
