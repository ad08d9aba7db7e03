"""Golden-vector generation, file IO and checking, plus exact host truth.

JAX-free port of ``caltech_bifrost_dsp_tpu/verification/golden.py``
(byte-compatible with the reference's make_golden_inputs.py): input files
are a one-line JSON header followed by uint8 4+4-bit samples in [ntime,
nchan, nstand, npol] order; correlation files hold complex128 [ntime//acc,
nchan, nstand, nstand, npol, npol] with ``corr[..., s0, s1, p0, p1] =
v(s0, p0) * conj(v(s1, p1))``.  Random inputs replicate the reference's
RNG stream (``np.random.RandomState(seed)``, per-block ``randint(0, 255)``).

:func:`host_corr_int32`, :func:`host_beams` and :func:`host_power` are the
host truths of ``scripts/tpu_parity.py:70-150``: exact float32 GEMMs for
the visibilities and float64 for the beams.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.codec import unpack_complex_np, unpack_np

DEFAULT_SEED = 0xdeadbeef  # reference: make_golden_inputs.py:20


def generate_input_blocks(ntime, nchan, nstand, npol, acc_len,
                          seed=DEFAULT_SEED, chanramp=False):
    """Yield uint8 [acc_len, nchan, nstand, npol] blocks, RNG-stream-exact
    with the reference generator."""
    if ntime % acc_len:
        raise ValueError("ntime must be a multiple of acc_len")
    nblock = ntime // acc_len
    if chanramp:
        d = np.zeros([nchan, nstand, npol], dtype=np.uint8)
        ramp = (np.arange(nchan, dtype=np.uint32) & 0xFF).astype(np.uint8)
        d[...] = ramp[:, None, None]
        block = np.broadcast_to(d, (acc_len, nchan, nstand, npol))
        for _ in range(nblock):
            yield block
    else:
        rng = np.random.RandomState(seed)
        for _ in range(nblock):
            yield rng.randint(0, 255, [acc_len, nchan, nstand, npol],
                              dtype=np.uint8)


def reference_correlation(block_u8: np.ndarray) -> np.ndarray:
    """Exact complex128 correlation of one block [ntime, nchan, nstand,
    npol] -> [nchan, nstand, nstand, npol, npol]."""
    ntime, nchan, nstand, npol = block_u8.shape
    dc = unpack_complex_np(block_u8).astype(np.complex128)
    x = dc.reshape(ntime, nchan, nstand * npol)
    # a batched complex128 product (BLAS) in place of the reference's
    # einsum: every sum of these integer products is exact in float64 in
    # any order, so the result is the einsum's bit for bit, ~10x sooner
    v = x.transpose(1, 2, 0) @ np.conj(x).transpose(1, 0, 2)
    v = v.reshape(nchan, nstand, npol, nstand, npol)
    return v.transpose(0, 1, 3, 2, 4)


def write_input_file(path, ntime, nchan, nstand, npol, acc_len,
                     seed=DEFAULT_SEED, chanramp=False, timestamp=0.0):
    """Write an ``in_*.dat`` golden input file."""
    meta = {"time": timestamp, "ntime": ntime, "nstand": nstand,
            "npol": npol, "nchan": nchan, "seed": seed,
            "shape": [ntime, nchan, nstand, npol], "dtype": "np.uint8",
            "type": "chanramp" if chanramp else "random"}
    with open(path, "wb") as fh:
        fh.write(json.dumps(meta).encode())
        fh.write(b"\n")
        for block in generate_input_blocks(ntime, nchan, nstand, npol,
                                           acc_len, seed, chanramp):
            fh.write(np.ascontiguousarray(block).tobytes())
    return meta


def write_corr_file(path, ntime, nchan, nstand, npol, acc_len,
                    seed=DEFAULT_SEED, chanramp=False, timestamp=0.0):
    """Write a ``corr_*.dat`` golden correlation file."""
    meta = {"time": timestamp, "acc_len": acc_len, "ntime": ntime // acc_len,
            "nstand": nstand, "npol": npol, "nchan": nchan, "seed": seed,
            "shape": [ntime // acc_len, nchan, nstand, nstand, npol, npol],
            "dtype": "np.complex",
            "type": "chanramp" if chanramp else "random"}
    with open(path, "wb") as fh:
        fh.write(json.dumps(meta).encode())
        fh.write(b"\n")
        for block in generate_input_blocks(ntime, nchan, nstand, npol,
                                           acc_len, seed, chanramp):
            fh.write(reference_correlation(block).tobytes())
    return meta


def read_dat(path):
    """Read a golden ``.dat`` file -> (meta dict, ndarray)."""
    with open(path, "rb") as fh:
        header = fh.readline()
        meta = json.loads(header.decode())
        dtype = {"np.uint8": np.uint8, "np.complex": np.complex128,
                 "complex128": np.complex128}[meta["dtype"]]
        data = np.frombuffer(fh.read(), dtype=dtype)
    return meta, data.reshape(meta["shape"])


def input_filename(datapath, ntime, nchan, nstand, npol,
                   seed=DEFAULT_SEED, chanramp=False):
    """Reference naming scheme (make_golden_inputs.py:64-69)."""
    if chanramp:
        return os.path.join(datapath, "in_%dt_%dc_%ds_%dp_chanramp.dat"
                            % (ntime, nchan, nstand, npol))
    return os.path.join(datapath, "in_%dt_%dc_%ds_%dp_%x.dat"
                        % (ntime, nchan, nstand, npol, seed))


def corr_filename(datapath, ntime, accshort, nchan, nstand, npol,
                  seed=DEFAULT_SEED, chanramp=False):
    if chanramp:
        return os.path.join(datapath, "corr_%dt_%da_%dc_%ds_%dp_chanramp.dat"
                            % (ntime, accshort, nchan, nstand, npol))
    return os.path.join(datapath, "corr_%dt_%da_%dc_%ds_%dp_%x.dat"
                        % (ntime, accshort, nchan, nstand, npol, seed))


def check_vis_against_golden(vis_dense: np.ndarray, golden: np.ndarray
                             ) -> bool:
    """Exact equality of a dense complex [nchan, ninput, ninput] matrix
    with a golden block [nchan, nstand, nstand, npol, npol]."""
    nchan, nstand, _, npol, _ = golden.shape
    g = golden.transpose(0, 1, 3, 2, 4).reshape(nchan, nstand * npol,
                                                nstand * npol)
    return bool(np.array_equal(vis_dense, g))


def host_corr_int32(block_u8: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact host correlation of one window via float32 GEMMs.

    uint8 [ntime, nchan, nstand, npol] -> (re, im) int32 [nchan, ninput,
    ninput].  Exact while every partial sum stays an integer below 2^24
    (ntime * 128 < 2^24, i.e. ntime < 131072)."""
    ntime, nchan, nstand, npol = block_u8.shape
    if ntime * 128 >= 1 << 24:
        raise ValueError("window too long for exact float32 sums")
    ni = nstand * npol
    re8, im8 = unpack_np(block_u8.reshape(ntime, nchan, ni))
    vr = np.empty((nchan, ni, ni), np.int32)
    vi = np.empty((nchan, ni, ni), np.int32)
    a = np.empty((2 * ntime, ni), np.float32)  # [r; i], refilled per channel
    r, i = a[:ntime], a[ntime:]
    for c in range(nchan):
        r[...] = re8[:, c, :]
        i[...] = im8[:, c, :]
        vr[c] = a.T @ a                        # r^T r + i^T i
        ir = i.T @ r
        vi[c] = ir - ir.T                      # i^T r - r^T i
    return vr, vi


def host_beams(block_u8: np.ndarray, gr: np.ndarray, gi: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Float64 beam voltages [nchan, nbeam, ntime] from a block [ntime,
    nchan, nstand, npol] and gain planes [nchan, nbeam, ninput]."""
    ntime, nchan, nstand, npol = block_u8.shape
    ni = nstand * npol
    re8, im8 = unpack_np(block_u8.reshape(ntime, nchan, ni))
    xr = re8.transpose(1, 0, 2).astype(np.float64)  # [c, t, ni]
    xi = im8.transpose(1, 0, 2).astype(np.float64)
    grt = gr.astype(np.float64).transpose(0, 2, 1)  # [c, ni, b]
    git = gi.astype(np.float64).transpose(0, 2, 1)
    br = xr @ grt - xi @ git                        # [c, t, b]
    bi = xi @ grt + xr @ git
    return br.transpose(0, 2, 1), bi.transpose(0, 2, 1)


def host_power(br, bi, ntime_sum: int) -> np.ndarray:
    """[nbeam//2, ntime//ntime_sum, nchan, 4] XX/YY/ReXY/ImXY (float64)."""
    nchan, nbeam, ntime = br.shape
    nblock = ntime // ntime_sum

    def split(z):
        z = z.reshape(nchan, nbeam // 2, 2, nblock, ntime_sum)
        return z[:, :, 0], z[:, :, 1]

    xr, yr = split(br)
    xi, yi = split(bi)
    out = np.stack([
        (xr * xr + xi * xi).sum(-1),
        (yr * yr + yi * yi).sum(-1),
        (xr * yr + xi * yi).sum(-1),
        (xi * yr - xr * yi).sum(-1)], axis=-1)
    return out.transpose(1, 2, 0, 3)
