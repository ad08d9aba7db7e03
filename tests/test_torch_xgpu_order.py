"""The port's xGPU register-tile order shims (``ops/xgpu_order.py``)
against the JAX package's, bit for bit, at ``tests/test_xgpu_order.py``'s
shapes, on visibilities from the port's correlator."""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.ops import xgpu_order as jxo
from caltech_bifrost_dsp_tpu_torch.ops import xgpu_order as xo
from caltech_bifrost_dsp_tpu_torch.ops.correlate import (chan_major,
                                                         correlate_chan_major)
from caltech_bifrost_dsp_tpu_torch.verification import golden

torch.set_num_threads(1)

NSTAND, NPOL, NCHAN, NTIME = 8, 2, 4, 48


def dense_vis():
    block = next(golden.generate_input_blocks(NTIME, NCHAN, NSTAND, NPOL,
                                              NTIME))
    packed = torch.from_numpy(block.reshape(NTIME, NCHAN, NSTAND * NPOL))
    vis = correlate_chan_major(chan_major(packed, "tci"))
    dense = vis.real.numpy() + 1j * vis.imag.numpy().astype(np.float64)
    ref = golden.reference_correlation(block)           # [c, s0, s1, p0, p1]
    want = ref.transpose(0, 1, 3, 2, 4).reshape(dense.shape)
    np.testing.assert_array_equal(dense, want)
    return dense


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_indices_bit_equal():
    ninput = NSTAND * NPOL
    i0, i1 = np.triu_indices(ninput)
    assert_bit_equal(xo.tri_index(i1, i0), jxo.tri_index(i1, i0))
    assert_bit_equal(xo.regtile_index(i0, i1, NSTAND),
                     jxo.regtile_index(i0, i1, NSTAND))
    for nstand in (4, 8, 352):
        assert xo.matlen_per_chan(nstand) == jxo.matlen_per_chan(nstand)


@pytest.mark.parametrize("wiring", ["natural", "permuted"])
def test_order_maps_and_packing_bit_equal(wiring):
    ant_to_input = np.arange(NSTAND * NPOL).reshape(NSTAND, NPOL)
    if wiring == "permuted":
        ant_to_input = np.random.RandomState(5).permutation(
            NSTAND * NPOL).reshape(NSTAND, NPOL)
    for got, want in zip(xo.baseline_order_maps(ant_to_input),
                         jxo.baseline_order_maps(ant_to_input)):
        assert_bit_equal(got, want)
    dense = dense_vis()
    buf = xo.pack_regtile(dense, ant_to_input)
    assert_bit_equal(buf, jxo.pack_regtile(dense, ant_to_input))


def test_unpack_and_reorder_bit_equal():
    dense = dense_vis()
    buf = xo.pack_regtile(dense)
    back = xo.unpack_regtile(buf, NSTAND, NPOL)
    assert_bit_equal(back, jxo.unpack_regtile(buf, NSTAND, NPOL))
    np.testing.assert_array_equal(back, dense)
    assert_bit_equal(xo.reorder_full(dense, NSTAND, NPOL),
                     jxo.reorder_full(dense, NSTAND, NPOL))
