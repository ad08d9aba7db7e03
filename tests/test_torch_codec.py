"""Port codec vs the JAX package's: bit-identical over every byte value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.utils import codec as jcodec
from caltech_bifrost_dsp_tpu_torch.utils import codec

torch.set_num_threads(1)

ALL = np.arange(256, dtype=np.uint8)


def test_unpack_all_bytes_matches_jax():
    jr, ji = jcodec.unpack_jnp(jnp.asarray(ALL))
    nr, ni = codec.unpack_np(ALL)
    tr, ti = codec.unpack(torch.from_numpy(ALL))
    assert tr.dtype == torch.int8 and ti.dtype == torch.int8
    for got in (nr, tr.numpy()):
        np.testing.assert_array_equal(got, np.asarray(jr))
    for got in (ni, ti.numpy()):
        np.testing.assert_array_equal(got, np.asarray(ji))


def test_high_nibble_is_real():
    re, im = codec.unpack(torch.tensor([0x7F, 0x80, 0x08], dtype=torch.uint8))
    assert re.tolist() == [7, -8, 0]
    assert im.tolist() == [-1, 0, -8]


def test_pack_roundtrip_and_matches_jax():
    rng = np.random.RandomState(1)
    re = rng.randint(-8, 8, (5, 7)).astype(np.int8)
    im = rng.randint(-8, 8, (5, 7)).astype(np.int8)
    want = np.asarray(jcodec.pack_jnp(jnp.asarray(re), jnp.asarray(im)))
    np.testing.assert_array_equal(codec.pack_np(re, im), want)
    got = codec.pack(torch.from_numpy(re), torch.from_numpy(im))
    np.testing.assert_array_equal(got.numpy(), want)
    r2, i2 = codec.unpack(got)
    np.testing.assert_array_equal(r2.numpy(), re)
    np.testing.assert_array_equal(i2.numpy(), im)


def test_unpack_complex_np_matches_jax():
    np.testing.assert_array_equal(codec.unpack_complex_np(ALL),
                                  jcodec.unpack_complex_np(ALL))


@pytest.mark.parametrize("bad", [(8, 0), (0, -9)])
def test_pack_np_rejects_out_of_range(bad):
    with pytest.raises(ValueError):
        codec.pack_np(np.array([bad[0]]), np.array([bad[1]]))
