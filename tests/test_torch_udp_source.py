"""The port's pure-Python snap2 reassembler (``io/source.py::
UdpSnap2Source``) against the JAX package's on the same datagrams: each
case sends one packet list to two loopback sockets, one read by each
package's source, and the gulps, ``nmissing`` and ``ngood_bytes`` must be
equal, and equal to what was sent where nothing was lost.  The shapes of
``tests/test_udp_source.py``; every socket is bound to a port the operating
system hands out."""

import dataclasses
import socket

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as jconfig
from caltech_bifrost_dsp_tpu.io import packets as jpk
from caltech_bifrost_dsp_tpu.io.source import UdpSnap2Source as JSource
from caltech_bifrost_dsp_tpu_torch import config as tconfig
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io.source import UdpSnap2Source

JCFG = jconfig.XEngineConfig(nstand=8, nchan=16, ntime_gulp=12, acc_len=24,
                             acc_len_slow=48, nbeam=4, ntime_sum=12,
                             npipeline=2)
CFG = tconfig.XEngineConfig(**dataclasses.asdict(JCFG))
G = CFG.ntime_gulp


def rx_socket():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    rx.bind(("127.0.0.1", 0))
    return rx


def packets(gulp, seq0):
    return list(pk.snap2_packets_for_gulp(
        gulp, seq0=seq0, chan0=0, nchan_tot=CFG.nchan, npol_tot=CFG.ninput,
        npol_per_pkt=8, nchan_per_pkt=8))


def make_gulps(n, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, [G, CFG.nchan, CFG.ninput]).astype(np.uint8)
            for _ in range(n)]


def both(pkts, seq_starts, timeout_s):
    """Send ``pkts`` to a port and a JAX source; capture ``seq_starts``
    with each.  Returns {name: (gulps, nmissing, ngood_bytes)}."""
    socks = {"port": rx_socket(), "jax": rx_socket()}
    srcs = {"port": UdpSnap2Source(CFG, socks["port"], timeout_s=timeout_s),
            "jax": JSource(JCFG, socks["jax"], timeout_s=timeout_s)}
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for raw in pkts:
        for s in socks.values():
            tx.sendto(raw, s.getsockname())
    out = {}
    for name, src in srcs.items():
        got = [src.capture_gulp(seq_start=s) for s in seq_starts]
        out[name] = (got, src.nmissing, src.ngood_bytes)
    tx.close()
    for s in socks.values():
        s.close()
    return out


def assert_same(out):
    (pg, pm, pb), (jg, jm, jb) = out["port"], out["jax"]
    assert (pm, pb) == (jm, jb)
    for a, b in zip(pg, jg):
        np.testing.assert_array_equal(a, b)


def test_loopback_roundtrip_matches_jax():
    gulp = make_gulps(1)[0]
    out = both(packets(gulp, 0), [0], timeout_s=3.0)
    assert_same(out)
    got, nmissing, nbytes = out["port"]
    np.testing.assert_array_equal(got[0], gulp)
    assert (nmissing, nbytes) == (0, gulp.nbytes)


def test_missing_packets_counted_like_jax():
    """The last three packets never arrive: holes zero, 3 missing."""
    gulp = make_gulps(1, seed=6)[0]
    out = both(packets(gulp, 0)[:-3], [0], timeout_s=0.5)
    assert_same(out)
    got, nmissing, _ = out["port"]
    assert nmissing == 3
    mask = got[0] != 0
    np.testing.assert_array_equal(got[0][mask], gulp[mask])


def test_boundary_interleaved_packets_are_stashed_like_jax():
    gulps = make_gulps(2, seed=7)
    p0, p1 = packets(gulps[0], 0), packets(gulps[1], G)
    order = (p0[:len(p0) // 2] + p1[:len(p1) // 2] + p0[len(p0) // 2:]
             + p1[len(p1) // 2:])
    out = both(order, [0, G], timeout_s=3.0)
    assert_same(out)
    got, nmissing, _ = out["port"]
    for a, b in zip(got, gulps):
        np.testing.assert_array_equal(a, b)
    assert nmissing == 0


@pytest.mark.parametrize("case", ["duplicates", "stale_and_far",
                                  "skipped_stash"])
def test_duplicates_stale_and_skipped_gulps_like_jax(case):
    """Duplicated datagrams land once (a gulp with one packet lost and one
    duplicated still counts the loss); packets of an emitted gulp and
    packets beyond the stash window are dropped; a stash the caller skips
    past is discarded."""
    gulps = make_gulps(3, seed=8)
    p = [packets(g, k * G) for k, g in enumerate(gulps)]
    if case == "duplicates":
        pkts = p[0][:5] + p[0][3:5] + p[0][6:] + p[1] + p[1][:4]
        starts = [0, G]
    elif case == "stale_and_far":
        far = packets(gulps[2], 10 * G)
        pkts = p[0] + far[:4] + p[0][:6] + p[1]
        starts = [0, G]
    else:
        pkts = p[0][:10] + p[1][:10] + p[0][10:] + p[2]
        starts = [0, 2 * G]
    out = both(pkts, starts, timeout_s=0.5)
    assert_same(out)
    got, nmissing, _ = out["port"]
    if case == "duplicates":
        assert nmissing == 1
        np.testing.assert_array_equal(got[1], gulps[1])
    else:
        assert nmissing == 0
        np.testing.assert_array_equal(got[0], gulps[0])
        np.testing.assert_array_equal(got[1], gulps[starts[1] // G])


def test_decoder_is_the_ports():
    """The reassembler decodes with the port's ``packets`` module, whose
    snap2 bytes equal the JAX encoder's."""
    gulp = make_gulps(1, seed=9)[0]
    mine = packets(gulp, 0)
    theirs = list(jpk.snap2_packets_for_gulp(
        gulp, seq0=0, chan0=0, nchan_tot=CFG.nchan, npol_tot=CFG.ninput,
        npol_per_pkt=8, nchan_per_pkt=8))
    assert mine == theirs
