"""xGPU "register-tile" baseline-order shims (port of
``caltech_bifrost_dsp_tpu/ops/xgpu_order.py``, numpy only).

The port's correlator keeps its visibilities in a dense, sane layout
(``[chan, input, input]``, entry ``[c, i, j] = sum_t v_i(t, c) * conj(v_j(t, c))``).
The reference's xGPU library instead emits a packed triangular "register
tile" order, and three native calls exist solely to navigate it:

- ``bfXgpuGetOrder``: build ``antpol_to_bl`` / ``bl_is_conj`` index maps
  (reference: pipeline/lwa352_pipeline/blocks/corr_block.py:317-333),
- ``bfXgpuSubSelect``: gather+conjugate+channel-sum by those maps
  (reference: blocks/corr_subsel_block.py:298),
- ``bfXgpuReorder``: unpack to ``[stand, stand, pol, pol, chan, cpx]``
  (reference: blocks/corr_output_full_block.py:669).

That layout is *not* propagated through the pipeline; this module provides
numpy shims that reproduce the exact indexing contract
(`tri_index`/`regtile_index` formulas from reference: corr_block.py:27-58
and verification/xgpu_test.py:22-52) so tests and any external consumer of
xGPU-ordered buffers can round-trip against the dense layout.
"""

from __future__ import annotations

import numpy as np


def tri_index(i, j):
    """Triangular index of an (i, j) pair, valid for i >= j
    (formula from reference: corr_block.py:27-28)."""
    i = np.asarray(i)
    return (i * (i + 1)) // 2 + j


def regtile_index(in0, in1, nstand):
    """Word index (per channel) of the real part of input-pair (in0, in1)
    in the xGPU register-tile buffer; valid for in1 >= in0.
    Vectorized version of the formula at reference: corr_block.py:37-58.
    """
    in0 = np.asarray(in0)
    in1 = np.asarray(in1)
    a0 = in0 >> 1
    a1 = in1 >> 1
    p0 = in0 & 1
    p1 = in1 & 1
    num_words_per_cell = 4
    quadrant_index = tri_index(a1 // 2, a0 // 2)
    quadrant = 2 * (a0 & 1) + (a1 & 1)
    quadrant_size = (nstand // 2 + 1) * nstand // 4
    cell_index = quadrant * quadrant_size + quadrant_index
    pol_offset = 2 * p1 + p0
    return cell_index * num_words_per_cell + pol_offset


def matlen_per_chan(nstand: int, npol: int = 2) -> int:
    """Complex words per channel in the register-tile buffer
    (reference: corr_block.py:231, divided by nchan)."""
    return (nstand // 2 + 1) * (nstand // 4) * npol * npol * 4


def baseline_order_maps(ant_to_input: np.ndarray):
    """Emulates ``bfXgpuGetOrder`` (call contract at reference:
    corr_block.py:317-333).

    Args:
      ant_to_input: ``[nstand, npol]`` int map from (stand, pol) to
        correlator input index.

    Returns:
      ``(antpol_to_bl, bl_is_conj)``, both ``[nstand, nstand, npol, npol]``
      int32.  ``antpol_to_bl[s0, s1, p0, p1]`` is the per-channel complex-word
      index of that pair in the register-tile buffer, and
      ``bl_is_conj`` is 1 where the buffer holds the conjugate of the desired
      product ``v(s0, p0) * conj(v(s1, p1))``.  (xGPU conjugates its *first*
      input, so for in1 >= in0 the buffer holds ``conj(v0) * v1`` — see the
      receiver fix-up at reference: test_receivers/corr_full_rx.py:94-99.)
    """
    ant_to_input = np.asarray(ant_to_input, dtype=np.int64)
    nstand, npol = ant_to_input.shape
    i0 = ant_to_input[:, None, :, None]   # [s0, 1, p0, 1]
    i1 = ant_to_input[None, :, None, :]   # [1, s1, 1, p1]
    i0b, i1b = np.broadcast_arrays(i0, i1)
    lo = np.minimum(i0b, i1b)
    hi = np.maximum(i0b, i1b)
    idx = regtile_index(lo, hi, nstand)
    is_conj = (i1b >= i0b).astype(np.int32)
    return idx.astype(np.int32), is_conj


def pack_regtile(vis: np.ndarray, ant_to_input: np.ndarray | None = None
                 ) -> np.ndarray:
    """Pack dense visibilities into an xGPU-ordered buffer.

    Args:
      vis: dense complex ``[nchan, ninput, ninput]`` with
        ``vis[c, i, j] = sum v_i * conj(v_j)``.
      ant_to_input: optional ``[nstand, npol]`` input map (identity
        ``input = npol*stand + pol`` by default).

    Returns:
      int32 ``[2, nchan, matlen_per_chan]``: plane 0 real, plane 1 imag —
      the layout the reference reads back at reference: corr_block.py:292.
      Entry ``[., c, regtile_index(i0, i1)]`` holds ``conj(v_i0) * v_i1``
      for ``i1 >= i0`` (xGPU conjugates its first input).
    """
    nchan, ninput, _ = vis.shape
    npol = 2
    nstand = ninput // npol
    if ant_to_input is None:
        ant_to_input = np.arange(ninput, dtype=np.int64).reshape(nstand, npol)
    inputs = np.asarray(ant_to_input).reshape(-1)
    # For every ordered input pair (a, b) with input-index ia <= ib, the
    # buffer word regtile_index(ia, ib) holds conj(v_ia) * v_ib = conj of
    # the dense entry vis[:, ia, ib].
    ia, ib = np.meshgrid(inputs, inputs, indexing="ij")
    mask = ib >= ia
    ia_l, ib_l = ia[mask], ib[mask]
    words = regtile_index(ia_l, ib_l, nstand)
    out = np.zeros((2, nchan, matlen_per_chan(nstand, npol)), dtype=np.int32)
    vals = np.conj(vis[:, ia_l, ib_l])           # [nchan, npair]
    out[0][:, words] = np.real(vals).astype(np.int64)
    out[1][:, words] = np.imag(vals).astype(np.int64)
    return out


def unpack_regtile(buf: np.ndarray, nstand: int, npol: int = 2) -> np.ndarray:
    """Inverse of :func:`pack_regtile`: xGPU buffer -> dense complex
    ``[nchan, ninput, ninput]`` with convention
    ``out[c, i, j] = v_i * conj(v_j)`` (full Hermitian matrix).
    """
    two, nchan, mlen = buf.shape
    assert two == 2 and mlen == matlen_per_chan(nstand, npol)
    ninput = nstand * npol
    inputs = np.arange(ninput, dtype=np.int64)
    ia, ib = np.meshgrid(inputs, inputs, indexing="ij")
    mask = ib >= ia
    ia_l, ib_l = ia[mask], ib[mask]
    words = regtile_index(ia_l, ib_l, nstand)
    re = buf[0][:, words].astype(np.float64)
    im = buf[1][:, words].astype(np.float64)
    raw = re + 1j * im                       # conj(v_ia) * v_ib
    dense = np.zeros((nchan, ninput, ninput), dtype=np.complex128)
    dense[:, ia_l, ib_l] = np.conj(raw)      # v_ia * conj(v_ib)
    dense[:, ib_l, ia_l] = raw               # Hermitian mirror
    return dense


def reorder_full(vis: np.ndarray, nstand: int, npol: int = 2) -> np.ndarray:
    """Emulates ``bfXgpuReorder`` output layout
    (reference: corr_output_full_block.py:669, receiver convention at
    test_receivers/corr_full_rx.py:94-99).

    Dense complex ``[nchan, ninput, ninput]`` ->
    int32 ``[nstand, nstand, npol, npol, nchan, 2]`` with
    ``out[s0, s1, p0, p1, c] = v(s0, p0) * conj(v(s1, p1))`` as (re, im).
    """
    nchan = vis.shape[0]
    v = vis.reshape(nchan, nstand, npol, nstand, npol)
    v = np.transpose(v, (1, 3, 2, 4, 0))  # [s0, s1, p0, p1, c]
    out = np.empty((nstand, nstand, npol, npol, nchan, 2), dtype=np.int32)
    out[..., 0] = np.real(v).astype(np.int64)
    out[..., 1] = np.imag(v).astype(np.int64)
    return out
