"""Port baseline subselection (plain path, as the kernel wrapper runs it
on CPU) vs the JAX package: exact int32, malformed pairs included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops import corr_subsel as jcs
from caltech_bifrost_dsp_tpu.ops.correlate import Vis as JVis
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops.correlate import Vis

torch.set_num_threads(1)

MALFORMED = [[800, 3], [3, 800], [-1, 4], [900, 900], [7, 7], [5, 2]]


@pytest.mark.parametrize("nvis,nstand", [(4704, 352), (4704, 16), (24, 3),
                                         (16, 8)])
def test_baseline_helpers_match_jax(nvis, nstand):
    want = jcs.production_baselines(nvis, nstand)
    assert cs.production_baselines(nvis, nstand) == want
    assert cs.default_baselines(nvis, nstand) == \
        jcs.default_baselines(nvis, nstand)
    np.testing.assert_array_equal(cs.baselines_to_inputs(want),
                                  jcs.baselines_to_inputs(want))
    with pytest.raises(ValueError):
        cs.baselines_to_inputs([[0, 1]])


def test_subsel_output_sfreq_matches_jax():
    args = (4.5e6, 192 * 24e3, 192, 4)
    assert cs.subsel_output_sfreq(*args) == jcs.subsel_output_sfreq(*args)


def _vis(seed, nchan, ni):
    rng = np.random.RandomState(seed)
    return [rng.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni)).astype(np.int32)
            for _ in range(2)]


@pytest.mark.parametrize("nchan,ninput,nchan_sum", [(16, 32, 4), (8, 72, 4),
                                                    (12, 20, 3)])
def test_corr_subsel_matches_jax_flat_take(nchan, ninput, nchan_sum):
    """Against the JAX ``corr_subsel`` at the true input width, where both
    clamp malformed pairs to ninput - 1."""
    r, i = _vis(1, nchan, ninput)
    rng = np.random.RandomState(2)
    pairs = np.concatenate([rng.randint(0, ninput, (200, 2)), MALFORMED])
    pairs = pairs.astype(np.int32)
    want = jcs.corr_subsel(JVis(jnp.asarray(r), jnp.asarray(i)),
                           jnp.asarray(pairs), nchan_sum)
    got = cs.corr_subsel(Vis(torch.from_numpy(r), torch.from_numpy(i)),
                         torch.from_numpy(pairs), nchan_sum)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))


@pytest.mark.parametrize("nstand,selection", [(48, "production"),
                                              (100, "default")])
def test_corr_subsel_matches_pallas_band_engine(nstand, selection):
    """Against ``corr_subsel_bands`` (the Pallas slab extractors, in
    interpret mode) on a 256-padded accumulator: the production selection
    takes the 2-D block branch, the autos-cycling default the take
    fallback."""
    ni, npad, nchan = 2 * nstand, 256, 8
    r, i = _vis(3, nchan, npad)
    make = (cs.production_baselines if selection == "production"
            else cs.default_baselines)
    pairs = cs.baselines_to_inputs(make(4704, nstand)).astype(np.int32)
    want = jcs.corr_subsel_bands(JVis(jnp.asarray(r), jnp.asarray(i)),
                                 jnp.asarray(pairs), 4, interpret=True)
    got = cs.corr_subsel(
        Vis(torch.from_numpy(r[:, :ni, :ni].copy()),
            torch.from_numpy(i[:, :ni, :ni].copy())),
        torch.from_numpy(pairs), 4)
    np.testing.assert_array_equal(got.real.numpy(), np.asarray(want.real))
    np.testing.assert_array_equal(got.imag.numpy(), np.asarray(want.imag))


def test_corr_subsel_reads_upper_triangle_only():
    """Entries below the diagonal may hold anything (the correlator kernel
    never writes them); the gather must not see them."""
    r, i = _vis(4, 4, 10)
    pairs = torch.tensor([[0, 5], [5, 0], [9, 2], [3, 3]], dtype=torch.int32)
    want = cs.corr_subsel(Vis(torch.from_numpy(r), torch.from_numpy(i)),
                          pairs, 4)
    lower = np.tril(np.ones((10, 10), bool), -1)
    r[:, lower] = 12345
    i[:, lower] = -777
    got = cs.corr_subsel(Vis(torch.from_numpy(r), torch.from_numpy(i)),
                         pairs, 4)
    assert torch.equal(got.real, want.real)
    assert torch.equal(got.imag, want.imag)
    assert torch.equal(got.imag[:, 0], -got.imag[:, 1])


def test_corr_subsel_rejects_ragged_channel_groups():
    r, i = _vis(5, 6, 4)
    with pytest.raises(ValueError):
        cs.corr_subsel(Vis(torch.from_numpy(r), torch.from_numpy(i)),
                       torch.zeros((2, 2), dtype=torch.int32), 4)
