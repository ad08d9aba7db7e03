"""The port's native loader (``caltech_bifrost_dsp_tpu_torch/io/native.py``):
its build of ``native/*.cpp``, the capture engine over loopback (round
trip, deliberate loss, a large gap, duplicates, mixed geometry, malformed
headers, backward resync, one buffer, bad destination buffers) and the
blaster's refusal of a zero-packet geometry, in the shapes of
``tests/test_native.py``; then against the JAX package: the C++ COR
packetizers' files byte-identical to the JAX native functions' and to the
port's Python encoder, and the same packets captured into the same gulps
and loss counts by both packages' engines.

Every UDP port is one the operating system hands out (bound to port 0 and
read back), so none collides with the JAX tests' fixed ports.  The
full-rate gates run only with ``CBD_FULL_RATE=1``, as in the JAX file.
"""

import dataclasses
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as jconfig
from caltech_bifrost_dsp_tpu.io import native as jnative
from caltech_bifrost_dsp_tpu_torch import config as tconfig
from caltech_bifrost_dsp_tpu_torch.io import native
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io import source as tsource

JCFG = jconfig.XEngineConfig(nstand=16, nchan=32, ntime_gulp=48,
                             acc_len=240, acc_len_slow=480, nbeam=4,
                             ntime_sum=12, npipeline=2)
CFG = tconfig.XEngineConfig(**dataclasses.asdict(JCFG))


def free_port() -> int:
    """A UDP port the operating system reports free on 127.0.0.1."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gulps(seed, n, cfg=CFG):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, [cfg.ntime_gulp, cfg.nchan, cfg.ninput])
            .astype(np.uint8) for _ in range(n)]


def snap2(cfg, seq, npol, pol0, fill, nchan=None, chan_block=0):
    nchan = cfg.nchan if nchan is None else nchan
    hdr = struct.pack("<QIHHHHIII", seq & (2 ** 64 - 1), 0xAABBCCDD, npol,
                      cfg.ninput, nchan, cfg.nchan, chan_block,
                      chan_block * max(nchan, 1), pol0)
    return hdr + bytes([fill]) * (nchan * npol)


class Loop:
    """A capture engine of the port on a free loopback port."""

    def __init__(self, cfg=CFG, nbuf=8):
        self.port = free_port()
        self.cap = native.NativeCapture(cfg, "127.0.0.1", self.port,
                                        nbuf=nbuf)
        self.cap.start()
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, data, seq0, **kw):
        kw.setdefault("nchan_per_pkt", 16)
        kw.setdefault("npol_per_pkt", 8)
        return native.transmit_gulp("127.0.0.1", self.port, data, seq0=seq0,
                                    **kw)

    def sendto(self, raw: bytes):
        self.tx.sendto(raw, ("127.0.0.1", self.port))

    def seqs(self, n, timeout_s=5.0):
        out = []
        for _ in range(n):
            seq0, _g = self.cap.get_gulp(timeout_s=timeout_s)
            if seq0 is None:
                break
            out.append(seq0)
        return out

    def close(self):
        stats = self.cap.stats()
        self.cap.close()
        self.tx.close()
        return stats


def test_build_is_the_ports_own():
    """The library lands in the port's ``_build`` under the hash of the
    sources, headers and flags, from the Makefile's flags, and is loaded
    once; ``native/`` is only read."""
    so = native.build()
    assert so.parent == native.BUILD_DIR
    assert so.name == f"libcbd_native_{native.source_hash()}.so"
    assert native.BUILD_DIR.parent.name == "caltech_bifrost_dsp_tpu_torch"
    assert native.load() is native.load()
    assert native.available()
    make = (native.NATIVE_DIR / "Makefile").read_text()
    assert "CXXFLAGS ?= " + " ".join(native.CXXFLAGS[:-1]) in make
    assert set(native.SOURCES) | set(native.HEADERS) == {
        p.name for p in native.NATIVE_DIR.iterdir()
        if p.suffix in (".cpp", ".h")}


def test_loopback_exact_roundtrip():
    lp = Loop()
    data = gulps(7, 3)
    sent = sum(lp.send(d, g * CFG.ntime_gulp) for g, d in enumerate(data))
    got = [lp.cap.get_gulp(timeout_s=10.0) for _ in data]
    stats = lp.close()
    assert [s for s, _ in got] == [g * CFG.ntime_gulp for g in range(3)]
    for (_, g), want in zip(got, data):
        np.testing.assert_array_equal(g, want)
    assert stats["npkt"] == sent
    assert stats["ngood_bytes"] == sum(d.nbytes for d in data)
    assert stats["nmissing"] == 0


def test_transmit_stream_advances_the_sequence():
    lp = Loop()
    data = gulps(8, 1)[0]
    sent = native.transmit_stream("127.0.0.1", lp.port, data, 3, seq0=480,
                                  nchan_per_pkt=16, npol_per_pkt=8)
    got = [lp.cap.get_gulp(timeout_s=10.0) for _ in range(3)]
    stats = lp.close()
    assert [s for s, _ in got] == [480 + g * CFG.ntime_gulp for g in range(3)]
    for _, g in got:
        np.testing.assert_array_equal(g, data)
    assert sent == stats["npkt"] == 3 * CFG.ntime_gulp * 2 * 4


def test_loopback_with_deliberate_loss():
    """Every 50th packet dropped: holes zero-filled and counted."""
    lp = Loop()
    data = gulps(7, 4)
    sent = sum(lp.send(d, g * CFG.ntime_gulp, miss_every=50)
               for g, d in enumerate(data))
    got = []
    for _ in data:
        seq0, g = lp.cap.get_gulp(timeout_s=3.0)
        if seq0 is None:
            break
        got.append((seq0, g.copy()))
    stats = lp.close()
    # a lossy gulp leaves only once the stream is 2 gulps past it
    assert len(got) >= len(data) - 2
    assert sent < 4 * (CFG.nchan // 16) * (CFG.ninput // 8) * CFG.ntime_gulp
    assert stats["nmissing"] > 0
    for (_, g), want in zip(got, data):
        mask = g != 0
        np.testing.assert_array_equal(g[mask], want[mask])


def test_capture_fast_forwards_over_large_gap():
    lp = Loop()
    data = gulps(9, 1)[0]
    for g in range(3):
        lp.send(data, g * CFG.ntime_gulp)
    gap0 = 1000 * CFG.ntime_gulp
    for g in range(3):
        lp.send(data, gap0 + g * CFG.ntime_gulp)
    seqs = lp.seqs(6, timeout_s=3.0)
    stats = lp.close()
    assert seqs[:3] == [0, CFG.ntime_gulp, 2 * CFG.ntime_gulp]
    assert seqs[3:] and all(s >= gap0 for s in seqs[3:])
    assert stats["nseq"] >= 2


def test_duplicate_packets_do_not_fake_completeness():
    """A duplicated packet must not complete a gulp: the holes of a gulp
    recycled into a slot with stale bytes are zeroed."""
    cfg = CFG.replace(ntime_gulp=12)
    lp = Loop(cfg, nbuf=2)

    def full(gulp_id, fill):
        for t in range(cfg.ntime_gulp):
            lp.sendto(snap2(cfg, gulp_id * cfg.ntime_gulp + t, cfg.ninput, 0,
                            fill))

    for g, fill in enumerate((0xAA, 0xBB, 0xCC)):
        full(g, fill)
        assert lp.cap.get_gulp(timeout_s=5.0)[0] == g * cfg.ntime_gulp
    full(3, 0x11)
    assert lp.cap.get_gulp(timeout_s=5.0)[0] == 3 * cfg.ntime_gulp
    lp.sendto(snap2(cfg, 4 * cfg.ntime_gulp, cfg.ninput, 0, 0xDD))
    lp.sendto(snap2(cfg, 4 * cfg.ntime_gulp, cfg.ninput, 0, 0xDD))
    time.sleep(0.05)
    full(5, 0xEE)
    seq0, data = lp.cap.get_gulp(timeout_s=5.0)
    stats = lp.close()
    assert seq0 == 4 * cfg.ntime_gulp
    assert (data[0] == 0xDD).all()
    assert (data[1:] == 0).all()
    assert stats["nmissing"] >= cfg.ntime_gulp - 1


def test_mixed_geometry_duplicates_do_not_fake_completeness():
    cfg = CFG.replace(ntime_gulp=4, ntime_sum=4)
    lp = Loop(cfg, nbuf=2)
    for t in range(cfg.ntime_gulp):
        lp.sendto(snap2(cfg, t, cfg.ninput, 0, 0x11))
    assert lp.cap.get_gulp(timeout_s=5.0)[0] == 0
    half, g1 = cfg.ninput // 2, cfg.ntime_gulp
    for _ in range(4):
        lp.sendto(snap2(cfg, g1, half, 0, 0x22))
    time.sleep(0.05)
    assert lp.cap.get_gulp(timeout_s=0.3)[0] is None
    lp.sendto(snap2(cfg, g1, half, half, 0x22))
    for t in range(1, cfg.ntime_gulp):
        lp.sendto(snap2(cfg, g1 + t, half, 0, 0x22))
        lp.sendto(snap2(cfg, g1 + t, half, half, 0x22))
    for t in range(cfg.ntime_gulp):
        lp.sendto(snap2(cfg, 2 * cfg.ntime_gulp + t, cfg.ninput, 0, 0x33))
    seq0, data = lp.cap.get_gulp(timeout_s=5.0)
    lp.close()
    assert seq0 == g1
    assert (data == 0x22).all()


def test_malformed_headers_do_not_crash_engine():
    lp = Loop(nbuf=4)

    def hdr(seq, npol, nchan):
        return snap2(CFG, seq, npol, 0, 0, nchan=nchan)[:32]

    lp.sendto(hdr(0, 8, 0))
    lp.sendto(hdr(0, 0, 16) + bytes(16))
    lp.sendto(hdr(0, 8, 7) + bytes(7 * 8))
    lp.sendto(hdr(-1, 8, 16) + bytes(16 * 8))
    lp.sendto(hdr(-(10 ** 12), 8, 16) + bytes(16 * 8))
    data = gulps(3, 1)[0]
    lp.send(data, 0)
    seq0, got = lp.cap.get_gulp(timeout_s=10.0)
    stats = lp.close()
    assert seq0 == 0
    np.testing.assert_array_equal(got, data)
    assert stats["nmissing"] == 0


def test_backward_resync_recovers():
    lp = Loop()
    data = gulps(5, 1)[0]
    high = 10_000 * CFG.ntime_gulp
    for g in range(3):
        lp.send(data, high + g * CFG.ntime_gulp)
    for g in range(3):
        lp.send(data, g * CFG.ntime_gulp)
    seqs = lp.seqs(6)
    stats = lp.close()
    low = [s for s in seqs if s < high]
    assert low == [g * CFG.ntime_gulp for g in range(len(low))]
    assert len(low) >= 3
    assert stats["nseq"] >= 2


def test_single_backward_straggler_does_not_resync():
    lp = Loop()
    data = gulps(11, 1)[0]
    high = 10_000 * CFG.ntime_gulp
    for g in range(4):
        lp.send(data, high + g * CFG.ntime_gulp)
        if g == 1:
            lp.sendto(pk.encode_snap2(pk.Snap2Header(
                seq=5, npol=8, npol_tot=CFG.ninput, nchan=16,
                nchan_tot=CFG.nchan, chan_block_id=0, chan0=0, pol0=0),
                np.zeros((16, 8), np.uint8)))
    got = []
    for _ in range(4):
        seq0, d = lp.cap.get_gulp(timeout_s=5.0)
        if seq0 is None:
            break
        got.append(seq0)
        np.testing.assert_array_equal(d, data)
    stats = lp.close()
    assert got == [high + g * CFG.ntime_gulp for g in range(4)]
    assert stats["nseq"] == 1
    assert stats["nmissing"] == 0


def test_nbuf_one_is_clamped_and_lossless():
    lp = Loop(nbuf=1)
    data = gulps(6, 3)
    got = []
    for g, d in enumerate(data):
        lp.send(d, g * CFG.ntime_gulp)
        if g >= 1:
            s, x = lp.cap.get_gulp(timeout_s=10.0)
            got.append((s, None if x is None else x.copy()))
    s, x = lp.cap.get_gulp(timeout_s=10.0)
    got.append((s, x))
    stats = lp.close()
    assert [s for s, _ in got] == [g * CFG.ntime_gulp for g in range(3)]
    for (_, g), want in zip(got, data):
        np.testing.assert_array_equal(g, want)
    assert stats["nmissing"] == 0


def test_transmit_rejects_zero_packet_geometry():
    data = np.zeros([CFG.ntime_gulp, CFG.nchan, CFG.ninput], np.uint8)
    with pytest.raises(OSError):
        native.transmit_gulp("127.0.0.1", free_port(), data, seq0=0,
                             nchan_per_pkt=16, npol_per_pkt=0)


def test_get_gulp_into_rejects_bad_buffers():
    lp = Loop(nbuf=2)
    try:
        with pytest.raises(ValueError):
            lp.cap.get_gulp_into(np.zeros(10, np.uint8), timeout_s=0.1)
        big = np.zeros(2 * CFG.gulp_nbyte, np.uint8)
        with pytest.raises(ValueError):
            lp.cap.get_gulp_into(big[::2], timeout_s=0.1)
        ro = np.zeros(CFG.gulp_nbyte, np.uint8)
        ro.flags.writeable = False
        with pytest.raises(ValueError):
            lp.cap.get_gulp_into(ro, timeout_s=0.1)
        # a timeout is None, not an error
        assert lp.cap.get_gulp_into(np.zeros(CFG.gulp_nbyte, np.uint8),
                                    timeout_s=0.1) is None
    finally:
        lp.close()


def test_capture_source_protocol():
    """``CaptureSource``: the port's sequence header, ``fill_into`` into a
    reservation-shaped buffer, None once stopped; ``AdcCaptureSource``
    refuses float32 ADC and tags its header."""
    port = free_port()
    src = native.CaptureSource(CFG, "127.0.0.1", port, poll_s=5.0)
    try:
        assert src.header(seq0=96) == tsource.sequence_header(CFG, 96)
        data = gulps(12, 1)[0]
        native.transmit_gulp("127.0.0.1", port, data, seq0=96,
                             nchan_per_pkt=16, npol_per_pkt=8)
        dest = np.zeros(CFG.gulp_nbyte, np.uint8)
        assert src.fill_into(dest) == 96
        np.testing.assert_array_equal(dest.reshape(data.shape), data)
        src.stop()
        assert src.fill_into(dest) is None
    finally:
        src.close()
    fx = CFG.replace(adc_dtype="float32")
    with pytest.raises(ValueError):
        native.AdcCaptureSource(fx, "127.0.0.1", free_port())
    adc = native.AdcCaptureSource(CFG.replace(adc_dtype="int8"),
                                  "127.0.0.1", free_port())
    try:
        h = adc.header(seq0=0)
        assert (h["nbit"], h["adc"], h["nchan"]) == (8, True, CFG.nchan)
        assert adc.cfg.nchan == 2 * CFG.nchan
    finally:
        adc.close()


# -- against the JAX package -------------------------------------------------

def planes(seed, cfg=CFG):
    rng = np.random.RandomState(seed)
    return [rng.randint(-2 ** 31, 2 ** 31, (cfg.nchan, cfg.ninput,
                                             cfg.ninput), dtype=np.int64)
            .astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("cor_fmt", [False, True])
def test_cor_packetizer_files_match_jax_and_python(tmp_path, cor_fmt):
    """The port's C++ packetizer to a file: the same bytes as the JAX
    native function's file and as the port's Python encoder's packets."""
    vr, vi = planes(1 + cor_fmt)
    sync, spectra, acc = 7, 480, CFG.ntime_gulp
    py = []
    sink.CorrFullOutput(CFG, send=py.append, use_cor_fmt=cor_fmt) \
        .send_matrix_planes(vr, vi, sync, spectra, acc)
    files = {}
    for name, mod in (("port", native), ("jax", jnative)):
        path = str(tmp_path / f"{name}.bin")
        if cor_fmt:
            fields = sink._cor_header_fields(CFG, sync, spectra, acc)
            n = mod.cor5c_send_matrix(vr, vi, CFG.nstand, CFG.npol, *fields,
                                      dump_path=path)
        else:
            n = mod.cor_send_matrix(
                vr, vi, CFG.nstand, CFG.npol, sync_time=sync,
                spectra_id=spectra, bw_hz=CFG.nchan * CFG.chan_bw_hz,
                sfreq_hz=CFG.sfreq_hz, acc_len=acc, chan0=CFG.chan0,
                dump_path=path)
        assert n == len(py) == CFG.nstand * (CFG.nstand + 1) // 2
        files[name] = open(path, "rb").read()
    assert files["port"] == files["jax"] == b"".join(py)


def test_capture_matches_jax_engine():
    """The same datagrams, lost and duplicated ones included, sent to a
    capture engine of each package: the same gulps and the same counts."""
    caps = {"port": Loop(), "jax": None}
    jport = free_port()
    jcap = jnative.NativeCapture(JCFG, "127.0.0.1", jport, nbuf=8)
    jcap.start()
    data = gulps(21, 4)
    pkts = []
    for g, d in enumerate(data):
        pkts += list(pk.snap2_packets_for_gulp(
            d, seq0=g * CFG.ntime_gulp, chan0=0, nchan_tot=CFG.nchan,
            npol_tot=CFG.ninput, npol_per_pkt=8, nchan_per_pkt=16))
    del pkts[100], pkts[400], pkts[401]   # lost
    pkts.insert(50, pkts[50])            # duplicated
    lp = caps["port"]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    for raw in pkts:
        tx.sendto(raw, ("127.0.0.1", lp.port))
        tx.sendto(raw, ("127.0.0.1", jport))
    # two more gulps release the lossy ones
    for g in (4, 5):
        lp.send(data[0], g * CFG.ntime_gulp)
        jnative.transmit_gulp("127.0.0.1", jport, data[0],
                              seq0=g * CFG.ntime_gulp, nchan_per_pkt=16,
                              npol_per_pkt=8)
    got = {}
    for name, cap in (("port", lp.cap), ("jax", jcap)):
        got[name] = []
        for _ in range(4):
            seq0, g = cap.get_gulp(timeout_s=5.0)
            got[name].append((seq0, None if g is None else g.copy()))
    # the counters once both engines have taken every datagram (the
    # releasing gulps may still be in flight when the 4th gulp is out)
    total = len(pkts) + 2 * CFG.ntime_gulp * (CFG.nchan // 16) * (
        CFG.ninput // 8)
    deadline = time.monotonic() + 10.0
    while (time.monotonic() < deadline
           and min(lp.cap.stats()["npkt"], jcap.stats()["npkt"]) < total):
        time.sleep(0.01)
    pstats, jstats = lp.close(), jcap.stats()
    jcap.close()
    tx.close()
    assert [s for s, _ in got["port"]] == [s for s, _ in got["jax"]] == [
        g * CFG.ntime_gulp for g in range(4)]
    for (_, a), (_, b) in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(a, b)
    assert pstats == jstats
    assert pstats["nmissing"] == 3 and pstats["npkt"] == total


# -- full-rate gates (CBD_FULL_RATE=1 on a quiet host) ------------------------

_FULL_RATE = pytest.mark.skipif(
    os.environ.get("CBD_FULL_RATE") != "1",
    reason="full-rate gate: set CBD_FULL_RATE=1 on a quiet host")


def _paced_run(cfg, gbps: float, ngulp: int) -> tuple[float, dict]:
    """``ngulp`` production gulps offered at ``gbps`` by the C++ blaster
    in a thread; returns the captured rate and the engine's counters."""
    port = free_port()
    cap = native.NativeCapture(cfg, "127.0.0.1", port, nbuf=16)
    cap.start()
    data = gulps(1, 1, cfg)[0]
    nburst = cfg.ntime_gulp / 16
    delay_ns = int(8 * data.nbytes / nburst / gbps)
    th = threading.Thread(target=native.transmit_stream, args=(
        "127.0.0.1", port, data, ngulp), kwargs=dict(
        nchan_per_pkt=64, npol_per_pkt=cfg.ninput, delay_ns=delay_ns))
    t0 = time.perf_counter()
    th.start()
    ngot = 0
    while ngot < ngulp and cap.get_gulp(timeout_s=3.0)[0] is not None:
        ngot += 1
    dt = time.perf_counter() - t0
    th.join()
    stats = cap.stats()
    cap.close()
    return 8 * ngot * data.nbytes / dt / 1e9, stats


@_FULL_RATE
def test_throughput_localhost():
    """A paced ~11 Gb/s stream at the production geometry, nearly
    loss-free."""
    cfg = CFG.replace(nstand=352, nchan=192, ntime_gulp=480)
    gbps, stats = _paced_run(cfg, 11.5, 30)
    assert gbps > 5.0
    assert stats["nmissing"] / max(stats["npkt"] + stats["nmissing"], 1) \
        < 0.02


@_FULL_RATE
def test_full_rate_single_engine_meets_reference_bar():
    """One engine sustains the 25.9 Gb/s real-time bar loss-free."""
    cfg = CFG.replace(nstand=352, nchan=192, ntime_gulp=480)
    gbps, stats = _paced_run(cfg, 1.15 * 25.9, 60)
    assert stats["nmissing"] == 0
    assert gbps >= 25.9, f"{gbps:.2f} Gb/s"


REFUSE_WAITFORONE = r"""
#define _GNU_SOURCE
#include <dlfcn.h>
#include <errno.h>
#include <sys/socket.h>
/* a kernel that refuses MSG_WAITFORONE, as gVisor's does */
int recvmmsg(int fd, struct mmsghdr *v, unsigned int n, int flags,
             struct timespec *t)
{
    static int (*real)(int, struct mmsghdr *, unsigned int, int,
                       struct timespec *);
    if (!real)
        real = dlsym(RTLD_NEXT, "recvmmsg");
    if (flags & MSG_WAITFORONE) {
        errno = EINVAL;
        return -1;
    }
    return real(fd, v, n, flags, t);
}
"""

CAPTURE_UNDER_REFUSAL = """
import socket, sys
import numpy as np
from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io import native
with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
cap = native.NativeCapture(TINY, "127.0.0.1", port, nbuf=4)
cap.start()
data = np.random.RandomState(4).randint(
    0, 256, (TINY.ntime_gulp, TINY.nchan, TINY.ninput)).astype(np.uint8)
native.transmit_gulp("127.0.0.1", port, data, seq0=0,
                     nchan_per_pkt=TINY.nchan, npol_per_pkt=TINY.ninput)
seq0, got = cap.get_gulp(timeout_s=10.0)
assert seq0 == 0 and np.array_equal(got, data), cap.stats()
print("captured", cap.stats())
"""


def test_capture_where_the_kernel_refuses_waitforone(tmp_path):
    """``native_compat.h``: under a ``recvmmsg`` that answers EINVAL to
    MSG_WAITFORONE (interposed with LD_PRELOAD), the port's capture engine
    still captures every packet."""
    import shutil
    import subprocess
    import sys

    gcc = shutil.which("gcc")
    if gcc is None:
        pytest.skip("needs gcc")
    src = tmp_path / "refuse.c"
    src.write_text(REFUSE_WAITFORONE)
    so = tmp_path / "librefuse.so"
    subprocess.run([gcc, "-shared", "-fPIC", "-o", str(so), str(src),
                    "-ldl"], check=True)
    native.build()  # outside the interposer
    repo = native.NATIVE_DIR.parent
    env = dict(os.environ, LD_PRELOAD=str(so), PYTHONPATH=str(repo))
    proc = subprocess.run([sys.executable, "-c", CAPTURE_UNDER_REFUSAL],
                          env=env, capture_output=True, text=True,
                          timeout=120, cwd=repo)
    assert proc.returncode == 0, proc.stderr
    assert "captured" in proc.stdout
