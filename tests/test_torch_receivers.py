"""The port's receiver CLIs against the JAX package's on the same packets.

The port's sinks (``io/sink.py``) encode each product at ``config.TINY``
into a list; the same bytes go over loopback UDP to each package's
``receive_*`` (and, for the three receivers ``chip_smoke.py`` runs as
processes, to each package's ``main`` in a thread).  The arrays are
equal, the file names are equal and the JSON headers equal apart from the
wall-clock ``"time"``; ``check_against_golden`` gives the same counts,
``snap_rx.sniff`` the same text and ``rate_stats`` the same counters."""

import io
import json
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.scripts import beam_rx as jbeam_rx
from caltech_bifrost_dsp_tpu.scripts import corr_part_rx as jcorr_part_rx
from caltech_bifrost_dsp_tpu.scripts import corr_rx as jcorr_rx
from caltech_bifrost_dsp_tpu.scripts import snap_rx as jsnap_rx
from caltech_bifrost_dsp_tpu_torch.config import TINY as CFG
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.scripts import (beam_rx, corr_part_rx,
                                                   corr_rx, probe_rx, snap_rx)
from caltech_bifrost_dsp_tpu_torch.verification import golden

torch.set_num_threads(1)

SYNC = 1_700_000_000
NB2 = CFG.nbeam // 2


def hermitian_planes(seed):
    rng = np.random.RandomState(seed)
    shape = (CFG.nchan, CFG.ninput, CFG.ninput)
    re = rng.randint(-2**20, 2**20, shape)
    im = rng.randint(-2**20, 2**20, shape)
    re = re + re.transpose(0, 2, 1)
    im = im - im.transpose(0, 2, 1)
    return re.astype(np.int32), im.astype(np.int32)


def cor_packets(use_cor_fmt: bool) -> list:
    pkts = []
    out = sink.CorrFullOutput(CFG, send=pkts.append, use_cor_fmt=use_cor_fmt)
    out.send_matrix_planes(*hermitian_planes(1), SYNC, 4800, CFG.acc_len)
    return pkts


def rx_socket():
    return sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=4, timeout_s=0.2)


def send_all(pkts, dest) -> None:
    """``pkts`` to ``dest`` over loopback, a pause every 32 so that a
    small receive buffer never overflows."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for i, p in enumerate(pkts):
            tx.sendto(p, dest)
            if i % 32 == 31:
                time.sleep(0.002)


def feed(pkts, receive, *args, **kw):
    """``receive`` on a fresh socket while a thread sends ``pkts`` to it."""
    rx = rx_socket()
    th = threading.Thread(target=send_all, args=(pkts, rx.getsockname()))
    th.start()
    try:
        return receive(rx, *args, **kw)
    finally:
        th.join(timeout=30)
        rx.close()


def read_rx_file(path):
    with open(path, "rb") as fh:
        meta = json.loads(fh.readline().decode())
        payload = fh.read()
    meta.pop("time")
    return meta, payload


def assert_same_files(got, want):
    assert got.rsplit("/", 1)[1] == want.rsplit("/", 1)[1]
    assert read_rx_file(got) == read_rx_file(want)


@pytest.mark.parametrize("use_cor_fmt", [False, True])
def test_receive_matrix_matches_jax(tmp_path, use_cor_fmt):
    pkts = cor_packets(use_cor_fmt)
    assert len(pkts) == CFG.nstand * (CFG.nstand + 1) // 2
    name = "receive_matrix_cor" if use_cor_fmt else "receive_matrix"
    args = (CFG.nstand, CFG.npol, CFG.nchan)
    jhdr, jbuf = feed(pkts, getattr(jcorr_rx, name), *args, timeout_s=5)
    hdr, buf = feed(pkts, getattr(corr_rx, name), *args, timeout_s=5)
    assert buf.dtype == np.complex128
    np.testing.assert_array_equal(buf, jbuf)
    re, im = hermitian_planes(1)
    dense = (re + 1j * im).reshape(CFG.nchan, CFG.nstand, CFG.npol,
                                   CFG.nstand, CFG.npol)
    np.testing.assert_array_equal(buf, dense.transpose(1, 3, 2, 4, 0))
    if not use_cor_fmt:
        (tmp_path / "j").mkdir()
        (tmp_path / "p").mkdir()
        assert_same_files(
            corr_rx.write_rx_file(str(tmp_path / "p"), hdr, buf,
                                  CFG.nstand, CFG.npol),
            jcorr_rx.write_rx_file(str(tmp_path / "j"), jhdr, jbuf,
                                   CFG.nstand, CFG.npol))


EDGES = np.array([0, 1, -1, 7, -7, 2**31 - 1, -2**31], np.int64)


def edge_packets(use_cor_fmt: bool) -> list:
    """One integration of planes drawn from zeros, small values and the
    int32 extremes (any planes: the sink sends the upper triangle)."""
    rng = np.random.RandomState(3)
    shape = (CFG.nchan, CFG.ninput, CFG.ninput)
    re, im = (EDGES[rng.randint(0, len(EDGES), shape)].astype(np.int32)
              for _ in range(2))
    pkts = []
    out = sink.CorrFullOutput(CFG, send=pkts.append, use_cor_fmt=use_cor_fmt)
    out.send_matrix_planes(re, im, SYNC, 4800, CFG.acc_len)
    return pkts


@pytest.mark.parametrize("use_cor_fmt", [False, True])
def test_receive_matrix_bytes_match_jax_at_int32_edges(use_cor_fmt):
    """The cube is the JAX receiver's byte for byte, signed zeros included,
    where the payload holds zeros and the int32 extremes."""
    pkts = edge_packets(use_cor_fmt)
    name = "receive_matrix_cor" if use_cor_fmt else "receive_matrix"
    args = (CFG.nstand, CFG.npol, CFG.nchan)
    _, jbuf = feed(pkts, getattr(jcorr_rx, name), *args, timeout_s=5)
    _, buf = feed(pkts, getattr(corr_rx, name), *args, timeout_s=5)
    assert buf.tobytes() == jbuf.tobytes()


@pytest.mark.parametrize("use_cor_fmt", [False, True])
def test_receive_matrix_timeout_says_how_far_it_came(use_cor_fmt):
    """A stream that stops short raises ``TimeoutError`` (as the JAX
    receiver does) naming the baselines received."""
    pkts = cor_packets(use_cor_fmt)
    name = "receive_matrix_cor" if use_cor_fmt else "receive_matrix"
    args = (CFG.nstand, CFG.npol, CFG.nchan)
    with pytest.raises(TimeoutError):
        feed(pkts[:-3], getattr(jcorr_rx, name), *args, timeout_s=0.5)
    with pytest.raises(TimeoutError, match=f"with {len(pkts) - 3} of "
                       f"{len(pkts)} baselines"):
        feed(pkts[:-3], getattr(corr_rx, name), *args, timeout_s=0.5)


def test_probe_rx_counts_a_whole_stream(capsys):
    """``probe_rx`` at a small width: one paced and one unpaced run, each
    received whole, reported in its JSON line."""
    assert probe_rx.main(["-s", "8", "-c", "4", "--paces", "50", "-1",
                          "--repeats", "1", "--burners", "0"]) == 0
    runs = json.loads(capsys.readouterr().out.splitlines()[-1])["probe_rx"]
    assert [r["pace_mbps"] for r in runs] == [50, -1]
    for r in runs:
        assert r["packets"] == 8 * 9 // 2
        assert (r["received"], r["lost"]) == (r["packets"], 0)


def golden_files(tmp_path):
    """A 3-block golden input and correlation file at TINY."""
    ntime = 3 * CFG.acc_len
    corrfile = str(tmp_path / "corr.dat")
    golden.write_corr_file(corrfile, ntime, CFG.nchan, CFG.nstand,
                           CFG.npol, CFG.acc_len)
    return corrfile


BASELINES = np.array(
    [[[s0, p0], [s1, p1]] for s0, s1 in ((0, 0), (0, 3), (2, 9), (15, 15),
                                         (4, 11), (7, 8), (1, 14),
                                         (5, 6), (3, 12), (10, 13))
     for p0 in range(2) for p1 in range(2)], np.int32)   # 40 baselines


def subsel_packets(corrfile, flip=False) -> list:
    """Two integrations of 2 x acc_len at t0 = 0 (the in-flight one the
    receiver skips) and t0 = acc_len, the second the golden sum of blocks
    1 and 2 summed to TINY's output channels."""
    _, gold = golden.read_dat(corrfile)
    nco = CFG.nchan // CFG.nchan_sum
    acc = (gold[1] + gold[2]).reshape(nco, CFG.nchan_sum, *gold.shape[2:])
    acc = acc.sum(axis=1)
    s0, p0, s1, p1 = (BASELINES[:, i // 2, i % 2] for i in range(4))
    vis = acc[:, s0, s1, p0, p1]                        # [nco, nvis]
    re = np.real(vis).astype(np.int32)
    im = np.imag(vis).astype(np.int32)
    if flip:
        re[2, 17] += 1
    pkts = []
    out = sink.CorrPartOutput(CFG, send=pkts.append)
    for t0 in (0, CFG.acc_len):
        out.send_subsel(re, im, BASELINES, SYNC, t0, 2 * CFG.acc_len)
    return pkts


@pytest.mark.parametrize("flip", [False, True])
def test_receive_part_and_golden_check_match_jax(tmp_path, flip):
    corrfile = golden_files(tmp_path)
    pkts = subsel_packets(corrfile, flip)
    assert len(pkts) == 2 * 3          # 16 + 16 + 8 baselines each
    nvis, nco = len(BASELINES), CFG.nchan // CFG.nchan_sum
    got = feed(pkts, corr_part_rx.receive_part, nvis, nco, timeout_s=5)
    want = feed(pkts, jcorr_part_rx.receive_part, nvis, nco, timeout_s=5)
    assert got[0].spectra_id == want[0].spectra_id == CFG.acc_len
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[1], BASELINES)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    fname = corr_part_rx.write_rx_file(str(tmp_path / "p"), *got)
    jfname = jcorr_part_rx.write_rx_file(str(tmp_path / "j"), *want)
    assert_same_files(fname, jfname)
    result = corr_part_rx.check_against_golden(corrfile, fname)
    assert result == jcorr_part_rx.check_against_golden(corrfile, jfname)
    assert result == ((nvis - 1, 1) if flip else (nvis, 0))


def power_packets() -> tuple[list, np.ndarray]:
    rng = np.random.RandomState(2)
    nblock = CFG.acc_len // CFG.ntime_sum
    power = rng.standard_normal((NB2, 2 * nblock, CFG.nchan, 4))
    power = power.astype(np.float32)
    pkts = []
    out = sink.PBeamOutput(CFG, senders={b: pkts.append for b in range(NB2)})
    for w in range(2):
        out.send_powers(power[:, w * nblock:(w + 1) * nblock],
                        w * CFG.acc_len, CFG.ntime_sum)
    return pkts, power


def test_receive_powers_matches_jax(tmp_path):
    pkts, power = power_packets()
    nseq = power.shape[1]
    got = feed(pkts, beam_rx.receive_powers, NB2, nseq, CFG.nchan,
               timeout_s=5)
    want = feed(pkts, jbeam_rx.receive_powers, NB2, nseq, CFG.nchan,
                timeout_s=5)
    assert got[1] == want[1] == list(range(0, 2 * CFG.acc_len,
                                           CFG.ntime_sum))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[2], power.transpose(1, 0, 2, 3))
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    assert_same_files(beam_rx.write_rx_file(str(tmp_path / "p"), *got),
                      jbeam_rx.write_rx_file(str(tmp_path / "j"), *want))


def test_stats_loop_matches_jax(capsys):
    pkts, _ = power_packets()
    got = feed(pkts, beam_rx.stats_loop, len(pkts), interval=7,
               timeout_s=5)
    got_text = capsys.readouterr().out
    want = feed(pkts, jbeam_rx.stats_loop, len(pkts), interval=7,
                timeout_s=5)
    want_text = capsys.readouterr().out
    assert got == want == [len(pkts), 0]      # server 1 of npipeline 2
    # the periodic lines carry the wall clock; the dump lines do not
    strip = [ln for ln in got_text.splitlines()
             if "packets_per_server" not in ln]
    assert strip == [ln for ln in want_text.splitlines()
                     if "packets_per_server" not in ln]
    assert len(strip) == len(pkts)


def snap_packets(seqs_by_src) -> list:
    rng = np.random.RandomState(4)
    pkts = []
    for (chan_block, pol0), seqs in seqs_by_src.items():
        for seq in seqs:
            hdr = pk.Snap2Header(seq=seq, npol=4, npol_tot=8, nchan=8,
                                 nchan_tot=16, chan_block_id=chan_block,
                                 chan0=chan_block * 8, pol0=pol0)
            payload = rng.randint(0, 256, (8, 4)).astype(np.uint8)
            pkts.append(pk.encode_snap2(hdr, payload))
    return pkts


def test_sniff_matches_jax():
    pkts = snap_packets({(0, 0): (5, 6, 7), (1, 4): (5, 6)})
    outs = []
    for sniff in (snap_rx.sniff, jsnap_rx.sniff):
        out = io.StringIO()
        assert feed(pkts, sniff, len(pkts), show_data=True, out=out) == 5
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert outs[0].count("seq=") == 5


def test_rate_stats_counts_match_jax():
    # source (0, 0): seqs 0, 1, 3 (one gap), then 3 again (out of order);
    # source (1, 4): 0, 1, 2, 6 (three missing)
    pkts = snap_packets({(0, 0): (0, 1, 3, 3), (1, 4): (0, 1, 2, 6)})
    got, want = (feed(pkts, fn, seconds=0.6, report_s=10.0,
                      out=io.StringIO())
                 for fn in (snap_rx.rate_stats, jsnap_rx.rate_stats))
    keys = ("npkt", "nbyte", "nsrc", "ngap", "nooo")
    assert [got[k] for k in keys] == [want[k] for k in keys]
    assert [got[k] for k in keys] == [8, sum(map(len, pkts)), 2, 4, 1]


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def udp_bound(port: int) -> bool:
    """Whether a socket holds UDP ``port`` (from ``/proc/net/udp``, so
    that looking never takes the port itself)."""
    lines = Path("/proc/net/udp").read_text().splitlines()[1:]
    return any(int(ln.split()[1].rsplit(":", 1)[1], 16) == port
               for ln in lines)


def wait_bound(port: int, timeout_s: float = 20.0) -> None:
    """Until a receiver holds ``port``."""
    deadline = time.monotonic() + timeout_s
    while not udp_bound(port):
        if time.monotonic() > deadline:
            raise TimeoutError(f"nothing bound port {port}")
        time.sleep(0.01)


def run_main(main, argv, pkts) -> int:
    """A receiver's ``main`` in a thread on a free port, fed ``pkts``."""
    port = free_port()
    rc = []
    th = threading.Thread(target=lambda: rc.append(
        main(argv + ["--ip", "127.0.0.1", "--port", str(port)])),
        daemon=True)
    th.start()
    wait_bound(port)
    send_all(pkts, ("127.0.0.1", port))
    th.join(timeout=30)
    assert not th.is_alive()
    return rc[0]


def test_receiver_clis_write_the_jax_files(tmp_path, capsys):
    """``corr_rx --cor-fmt``, ``corr_part_rx --goldfile`` and ``beam_rx
    --capture``, as ``chip_smoke.py`` runs them, write the JAX CLIs'
    files and exit with their codes."""
    corrfile = golden_files(tmp_path)
    nvis, nco = len(BASELINES), CFG.nchan // CFG.nchan_sum
    cases = [
        (corr_rx, jcorr_rx, ["--cor-fmt", "-s", str(CFG.nstand), "-c",
                             str(CFG.nchan)], cor_packets(True), 0),
        (corr_part_rx, jcorr_part_rx, ["-c", str(nco), "-b", str(nvis),
                                       "--timeout", "10", "-i", corrfile],
         subsel_packets(corrfile), 0),
        (corr_part_rx, jcorr_part_rx, ["-c", str(nco), "-b", str(nvis),
                                       "--timeout", "10", "-i", corrfile],
         subsel_packets(corrfile, flip=True), 1),
        (beam_rx, jbeam_rx, ["--capture", "--nbeam", str(NB2), "--nseq",
                             "40", "-c", str(CFG.nchan), "--timeout", "10"],
         power_packets()[0], 0),
    ]
    for k, (mod, jmod, argv, pkts, code) in enumerate(cases):
        files = []
        for m in (mod, jmod):
            out = tmp_path / f"{k}{m is mod}"
            out.mkdir()
            path_flag = "--outpath" if m in (corr_rx, jcorr_rx) else "-f"
            assert run_main(m.main, argv + [path_flag, str(out)],
                            pkts) == code
            files += [str(f) for f in out.iterdir()]
        assert len(files) == 2
        assert_same_files(*files)
    capsys.readouterr()
