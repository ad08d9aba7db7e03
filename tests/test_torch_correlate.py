"""Port correlator (plain path, as the kernel wrapper runs it on CPU) vs
the JAX package: exact int32 everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops import correlate as jcorr
from caltech_bifrost_dsp_tpu.ops.pallas.corr_blk import (packed_corr_blk_acc,
                                                         padded_ni)
from caltech_bifrost_dsp_tpu.ops.pallas.corr_triu import mirror_vis as jmirror
from caltech_bifrost_dsp_tpu_torch.ops import correlate as corr
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import corr_acc

torch.set_num_threads(1)

# (ntime, nchan, ninput): TINY, CPU_REF and a ragged geometry
SHAPES = [(48, 16, 32), (120, 64, 32), (48, 8, 72)]
FLAGS = [(True, False, False), (False, False, False), (False, True, True),
         (False, True, False), (True, True, False), (True, True, True)]


def _packed(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _eq(vis_t, real, imag):
    np.testing.assert_array_equal(vis_t.real.numpy(), np.asarray(real))
    np.testing.assert_array_equal(vis_t.imag.numpy(), np.asarray(imag))


@pytest.mark.parametrize("shape", SHAPES)
def test_correlate_gulp_matches_jax(shape):
    p = _packed(1, shape)
    want = jcorr.correlate_gulp(jnp.asarray(p))
    _eq(corr.correlate_gulp(torch.from_numpy(p)), want.real, want.imag)


def test_correlate_accumulate_matches_jax():
    p = _packed(2, (96, 4, 24))
    acc0 = jcorr.correlate_gulp(jnp.asarray(_packed(3, (48, 4, 24))))
    want = jcorr.correlate_accumulate(jnp.asarray(p), 48, acc0)
    got = corr.correlate_accumulate(
        torch.from_numpy(p), 48,
        corr.Vis(torch.from_numpy(np.array(acc0.real)),
                 torch.from_numpy(np.array(acc0.imag))))
    _eq(got, want.real, want.imag)
    with pytest.raises(ValueError):
        corr.correlate_accumulate(torch.from_numpy(p), 40)


def test_mirror_vis_matches_jax():
    rng = np.random.RandomState(4)
    r = rng.randint(-99, 99, (3, 20, 20)).astype(np.int32)
    i = rng.randint(-99, 99, (3, 20, 20)).astype(np.int32)
    want = jmirror(jcorr.Vis(jnp.asarray(r), jnp.asarray(i)))
    got = corr.mirror_vis(corr.Vis(torch.from_numpy(r), torch.from_numpy(i)))
    _eq(got, want.real, want.imag)


def test_chan_major_layouts_agree():
    p = _packed(5, (12, 3, 10))
    cti = np.zeros((3, 12, 16), np.uint8)
    cti[:, :, :10] = p.transpose(1, 0, 2)
    cti[:, :, 10:] = 0xA5     # don't-care pad lanes
    a = corr.chan_major(torch.from_numpy(p), "tci", 10)
    b = corr.chan_major(torch.from_numpy(cti), "cti", 10)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        corr.chan_major(torch.from_numpy(p), "ict")
    with pytest.raises(ValueError):
        corr.chan_major(torch.from_numpy(p), "tci", 11)


def test_corr_acc_flag_algebra_matches_pallas_kernel():
    """Every boundary-flag combination, in place and from random carried
    state, against the Pallas ``packed_corr_blk_acc`` in interpret mode at
    the ragged geometry (test_torch_xengine covers the other sizes through
    the step); compared on j >= i, the half both engines guarantee."""
    ntime, nchan, ni = shape = SHAPES[2]
    npad = padded_ni(ni)
    p = _packed(6, shape)
    rng = np.random.RandomState(7)
    upper = np.triu(np.ones((ni, ni), bool))
    for flags in FLAGS:
        planes = [rng.randint(-9999, 9999, (nchan, ni, ni)).astype(np.int32)
                  for _ in range(4)]

        def pad(a):
            out = np.zeros((nchan, npad, npad), np.int32)
            out[:, :ni, :ni] = a
            return jnp.asarray(out)

        jf, js = packed_corr_blk_acc(
            jnp.asarray(p), jcorr.Vis(pad(planes[0]), pad(planes[1])),
            jcorr.Vis(pad(planes[2]), pad(planes[3])), *flags,
            interpret=True)
        t = [torch.from_numpy(a.copy()) for a in planes]
        fast, slow = corr.Vis(*t[:2]), corr.Vis(*t[2:])
        corr_acc(torch.from_numpy(p), fast, slow, *flags)
        for got, want in zip((*fast, *slow), (*jf, *js)):
            want = np.asarray(want)[:, :ni, :ni]
            np.testing.assert_array_equal(got.numpy()[:, upper],
                                          want[:, upper], err_msg=str(flags))


def test_corr_acc_cti_padded_equals_tci():
    p = _packed(8, (48, 8, 72))
    cti = np.full((8, 48, 128), 0x5A, np.uint8)
    cti[:, :, :72] = p.transpose(1, 0, 2)
    out = []
    for packed, layout in ((p, "tci"), (cti, "cti")):
        st = corr.zero_vis(8, 72), corr.zero_vis(8, 72)
        corr_acc(torch.from_numpy(packed), *st, True, True, True,
                 layout=layout)
        out.append(st)
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a.real, b.real) and torch.equal(a.imag, b.imag)


def test_zero_vis_planes_do_not_alias():
    v = corr.zero_vis(2, 4)
    v.real.add_(1)
    assert int(v.imag.abs().sum()) == 0


def test_kernel_wrappers_take_only_cpu_or_cuda_tensors():
    """A wrapper runs its plain version only for CPU tensors; anything else
    that is not CUDA raises instead of falling back."""
    from caltech_bifrost_dsp_tpu_torch.ops.beamform import (
        BeamGains, beamform_products)
    from caltech_bifrost_dsp_tpu_torch.ops.corr_subsel import corr_subsel

    packed = torch.empty((48, 4, 8), dtype=torch.uint8, device="meta")
    st = corr.zero_vis(4, 8, "meta"), corr.zero_vis(4, 8, "meta")
    with pytest.raises(ValueError):
        corr_acc(packed, *st, True, True, True)
    with pytest.raises(ValueError):
        corr_acc(torch.zeros((48, 4, 8), dtype=torch.uint8), *st, True,
                 True, True)
    gains = BeamGains(torch.empty((4, 2, 8), device="meta"),
                      torch.empty((4, 2, 8), device="meta"))
    with pytest.raises(ValueError):
        beamform_products(packed, gains, 12)
    with pytest.raises(ValueError):
        corr_subsel(st[0], torch.zeros((2, 2), dtype=torch.int32), 4)
