"""The port's wire formats against ``caltech_bifrost_dsp_tpu/io/packets.py``:
every encoder byte-identical to the JAX encoder on the same seeded
fields and payload, every decoder back to the same fields and payload,
and the COR scatter equal to the JAX receiver's on the same packets."""

import dataclasses

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu.io import packets as jpk
from caltech_bifrost_dsp_tpu_torch.io import packets as pk


def _fields(rng, cls, **fixed):
    """Seeded header fields: ints in range of their struct slot, floats
    for the frequency fields."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in fixed:
            out[f.name] = fixed[f.name]
        elif f.name in ("bw_hz", "sfreq_hz"):
            out[f.name] = float(rng.uniform(0, 2e8))
        else:
            out[f.name] = int(rng.randint(0, 250))
    return out


def _case(name, rng):
    """(port header, JAX header, payload arrays, encode name) of one
    format with random header fields and payload."""
    if name == "snap2":
        f = _fields(rng, pk.Snap2Header, nchan=12, npol=8, seq=2 ** 40 + 7)
        data = (rng.randint(0, 256, (12, 8)).astype(np.uint8),)
        return pk.Snap2Header(**f), jpk.Snap2Header(**f), data
    if name == "corr_full":
        f = _fields(rng, pk.CorrFullHeader, npols=2, nchans=12)
        data = (rng.randint(-2 ** 31, 2 ** 31 - 1, (2, 2, 12, 2),
                            dtype=np.int64).astype(np.int32),)
        return pk.CorrFullHeader(**f), jpk.CorrFullHeader(**f), data
    if name == "cor":
        f = _fields(rng, pk.CorHeader, frame_number=0xABCDEF,
                    time_tag=2 ** 50 + 3, cor_navg=2 ** 31 + 5)
        data = (rng.randint(-2 ** 31, 2 ** 31 - 1, (12, 2, 2, 2),
                            dtype=np.int64).astype(np.int32),)
        return pk.CorHeader(**f), jpk.CorHeader(**f), data
    if name == "corr_part":
        f = _fields(rng, pk.CorrPartHeader, nvis=5, nchans=3)
        data = (rng.randint(0, 352, (5, 2, 2)).astype(np.uint32),
                rng.randint(-9999, 9999, (5, 3, 2)).astype(np.int32))
        return pk.CorrPartHeader(**f), jpk.CorrPartHeader(**f), data
    if name == "pbeam":
        f = _fields(rng, pk.PBeamHeader, nchan=12, nbeam=1,
                    navg=24, chan0=4000, seq=2 ** 40)
        data = (rng.randn(12, 1, 4).astype(np.float32),)
        return pk.PBeamHeader(**f), jpk.PBeamHeader(**f), data
    f = _fields(rng, pk.IBeamHeader, nchan=12, nbeam=2, chan0=4000,
                seq=2 ** 40)
    data = (rng.randn(12, 2, 2).astype(np.float32),)
    return pk.IBeamHeader(**f), jpk.IBeamHeader(**f), data


@pytest.mark.parametrize("name", ["snap2", "corr_full", "cor", "corr_part",
                                  "pbeam", "ibeam"])
@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_bytes_and_round_trip(name, seed):
    rng = np.random.RandomState(seed)
    hdr, jhdr, data = _case(name, rng)
    got = getattr(pk, f"encode_{name}")(hdr, *data)
    want = getattr(jpk, f"encode_{name}")(jhdr, *data)
    assert got == want
    back = getattr(pk, f"decode_{name}")(got)
    assert back[0] == hdr
    for a, b in zip(back[1:], data):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["snap2", "corr_full", "cor", "corr_part",
                                  "pbeam", "ibeam"])
def test_encoder_refuses_wrong_payload_shape(name):
    rng = np.random.RandomState(5)
    hdr, _, data = _case(name, rng)
    bad = list(data)
    bad[-1] = bad[-1][..., :1]
    with pytest.raises(ValueError):
        getattr(pk, f"encode_{name}")(hdr, *bad)


def test_snap2_gulp_packets_match_jax():
    rng = np.random.RandomState(3)
    gulp = rng.randint(0, 256, (3, 8, 128)).astype(np.uint8)
    got = list(pk.snap2_packets_for_gulp(gulp, 100, 64, 256, 704,
                                         npol_per_pkt=64, nchan_per_pkt=4))
    want = list(jpk.snap2_packets_for_gulp(gulp, 100, 64, 256, 704,
                                           npol_per_pkt=64, nchan_per_pkt=4))
    assert got == want and len(got) == 3 * 2 * 2
    with pytest.raises(ValueError, match="magic"):
        pk.decode_snap2(b"\0" * 32 + got[0][32:])


@pytest.mark.parametrize("args", [(1, 32, 1), (4, 32, 32), (4, 32, 33),
                                  (255, 255, 0)])
def test_cor_frame_number_matches_jax(args):
    assert pk.cor_frame_number(*args) == jpk.cor_frame_number(*args)


@pytest.mark.parametrize("nstand,nchan", [(4, 6), (5, 3)])
def test_cor_scatter_matches_jax(nstand, nchan):
    """A full upper triangle of COR packets (autos Hermitian, as a real
    correlator writes them) scatters to the JAX receiver's cube; a second
    stream offset in frequency lands in its own channels."""
    rng = np.random.RandomState(nstand)
    pkts = []
    for c0 in (0, nchan):
        for i in range(nstand):
            for j in range(i, nstand):
                d = rng.randint(-500, 500, (nchan, 2, 2, 2)).astype(np.int32)
                if i == j:
                    d[:, 1, 0, 0] = d[:, 0, 1, 0]
                    d[:, 1, 0, 1] = -d[:, 0, 1, 1]
                    d[:, 0, 0, 1] = d[:, 1, 1, 1] = 0
                hdr = pk.CorHeader(frame_number=1, secs_count=0,
                                   freq_count=c0, cor_gain=0, time_tag=0,
                                   cor_navg=1, stand_i=i + 1,
                                   stand_j=j + 1)
                pkts.append(pk.encode_cor(hdr, d))
    got = pk.cor_scatter_matrix(pkts, nstand, nchan_tot=2 * nchan)
    want = jpk.cor_scatter_matrix(pkts, nstand, nchan_tot=2 * nchan)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and np.abs(got).sum() > 0
    with pytest.raises(ValueError, match="sync"):
        pk.decode_cor(b"\0" * 4 + pkts[0][4:])
