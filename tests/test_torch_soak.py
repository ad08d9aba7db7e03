"""The port's soak (``scripts/soak.py``), the counterpart of the JAX
package's ``tests/test_soak.py``.

- The long runs (``CBD_SOAK=1``; ``CBD_SOAK_S`` seconds, default 30, and
  ``CBD_SOAK_RATE`` gulps a second, default the leg's): the three legs on
  the card, ``full`` also marked ``cuda``, each merged into
  ``SOAK_torch.json`` (or ``CBD_SOAK_ARTIFACT``).  Without a card they
  skip; ``CBD_SOAK_DEVICE=cpu`` runs ``xb`` and ``fx`` on the plain
  versions instead, on request only.  On a GPU host without JAX run them as
  ``CBD_SOAK=1 CBD_SOAK_S=900 python -m pytest --noconftest
  tests/test_torch_soak.py``.
- Short cases on the CPU: the ``xb`` and ``fx`` legs for ~7 s each with
  the break, the trigger and the memory gates, and the ``full`` leg's exact
  products at a small shape (48 stands, 4 channels).
- Each gate shown to fail: a flipped integer in a slow dump, a rising
  memory trajectory, no packets after the break.
- The full leg's truth held to the JAX correlator.
- The loopback pieces ``chip_smoke.py`` shares: the blaster with no pace
  into a capture, and the ``recvmmsg`` binding.
"""

import copy
import ctypes
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import threading
import time
from multiprocessing import shared_memory
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.config import TINY
from caltech_bifrost_dsp_tpu_torch.io import native
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.scripts import soak, soak_wire

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SOAK = os.environ.get("CBD_SOAK") == "1"
#: a short run: seconds and gulps a second, gentle for a loaded CPU
SHORT_S, SHORT_RATE = 6.0, 25.0
#: the full leg's logic at a shape the CPU runs in seconds: 48 stands
#: (the production selection's), 4 channels, slow dumps of 2 windows
SMALL_FULL = TINY.replace(nstand=48, nchan=4, nbeam=2)
SMALL_SLOW = 480

long_run = pytest.mark.skipif(
    not SOAK, reason="soak gate: set CBD_SOAK=1 (wall-clock heavy, "
                     "~CBD_SOAK_S seconds a leg)")


def _record(leg: str, rec: dict) -> None:
    path = os.environ.get("CBD_SOAK_ARTIFACT", str(REPO / "SOAK_torch.json"))
    soak.write_record(path, leg, rec)


@long_run
@pytest.mark.parametrize("leg", ["xb", "fx"])
def test_soak_leg(leg):
    device = os.environ.get("CBD_SOAK_DEVICE", "cuda")
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CBD_SOAK_DEVICE=cpu asks for the "
                    "plain versions)")
    rate = os.environ.get("CBD_SOAK_RATE")
    rec, _ = soak.run_leg(leg, float(os.environ.get("CBD_SOAK_S", "30")),
                          None if rate is None else float(rate), device)
    _record(leg, rec)
    assert rec["pass"], rec["failures"]


@long_run
@pytest.mark.cuda
def test_soak_full_width():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rate = os.environ.get("CBD_SOAK_RATE")
    rec, _ = soak.run_leg("full", float(os.environ.get("CBD_SOAK_S", "30")),
                          None if rate is None else float(rate), "cuda")
    _record("full", rec)
    assert rec["pass"], rec["failures"]


@pytest.fixture(scope="module")
def short(tmp_path_factory):
    """The short runs on the CPU, once for the module: leg -> (record,
    observation)."""
    starts = []
    runs = {leg: soak.run_leg(leg, SHORT_S, SHORT_RATE, "cpu",
                              on_start=lambda leg=leg: starts.append(leg))
            for leg in ("xb", "fx")}
    runs["full"] = soak.run_leg("full", SHORT_S, SHORT_RATE, "cpu",
                                acc_len_slow=SMALL_SLOW, cfg=SMALL_FULL,
                                on_start=lambda: starts.append("full"))
    runs["starts"] = starts
    return runs


@pytest.mark.parametrize("leg", ["xb", "fx", "full"])
def test_short_leg_passes_on_cpu(short, leg):
    """No packet missing, a second sequence, slow dumps on both sides of
    the break, the trigger's file replayed, the monitor published, memory
    within its gate, and (full) every product exact."""
    rec, obs = short[leg]
    assert rec["failures"] == [] and rec["pass"], rec["failures"]
    assert rec["nmissing"] == 0 and rec["nseq"] == 2
    assert rec["ndumps_pre_break"] and rec["ndumps_post_break"]
    assert rec["dump_file"] and obs["monitor_keys"]
    assert rec["rss_growth_mb"] < soak.RSS_GROWTH_MB
    assert rec["segment_b_gulps"] >= (11 * obs["cfg"].acc_len + 4 *
                                      obs["cfg"].acc_len_slow
                                      ) // obs["cfg"].ntime_gulp
    assert all(n > 0 for n in rec["wire_packets"].values())
    if leg == "fx":
        assert set(obs["tone_chans"]) == {soak.TONE}
    if leg == "full":
        assert rec["subsel_windows"] == rec["subsel_windows_exact"] \
            == rec["ndump_fast"] > 0
        assert rec["slow_dumps_exact"] == rec["ndump_slow"] > 0
        assert rec["reduced"]


def test_cpu_runs_start_once_and_name_no_card(short):
    """``on_start`` runs once a leg, after the warm-up; a run on the CPU
    is stamped with no card, whatever ``nvidia-smi`` answers."""
    assert short["starts"] == ["xb", "fx", "full"]
    for leg in ("xb", "fx", "full"):
        rec, _ = short[leg]
        assert rec["device"] == "cpu"
        assert rec["card"] is None and rec["power_limit"] is None


def test_flipped_integer_fails_the_truth_check(short):
    _, obs = short["full"]
    cfg = obs["cfg"]
    fast = soak.full_truth(cfg, obs["frames"], "cpu")
    nwin = cfg.acc_len_slow // cfg.acc_len
    re, im = (p * np.int32(nwin) for p in fast)
    grab = soak.SlowGrab(fast, nwin)
    grab.send_matrix_planes(re, im, 0, 0, cfg.acc_len_slow)
    re[2, 5, 7] += 1
    grab.send_matrix_planes(re, im, 0, cfg.acc_len_slow, cfg.acc_len_slow)
    assert grab.exact == [True, False]
    bad = dict(obs, slow_seq0=grab.seq0, slow_exact=grab.exact)
    assert any(f.startswith("slow dumps") for f in soak.check_leg(bad))
    assert soak.check_leg(obs) == []


def test_rising_memory_fails_the_memory_gate():
    gulp = soak.leg_config("full")[0].gulp_nbyte
    quarter = {"rss_highwater_mb": 500.0, "reserved_mb": 1000.0}
    assert soak.memory_gate(quarter, {"rss_highwater_mb": 799.0,
                                      "reserved_mb": 1000.0}, gulp) == []
    rss = soak.memory_gate(quarter, {"rss_highwater_mb": 800.0,
                                     "reserved_mb": 1000.0}, gulp)
    dev = soak.memory_gate(quarter, {"rss_highwater_mb": 500.0,
                                     "reserved_mb": 1000.0
                                     + 2 * gulp / 1e6}, gulp)
    assert len(rss) == 1 and "RSS" in rss[0]
    assert len(dev) == 1 and "memory_reserved" in dev[0]
    assert soak.memory_gate(None, {}, gulp)
    # a trajectory rising 40 MB a sample: flat enough over two samples
    # after the quarter mark, a leak over ten
    rising = [{"rss_highwater_mb": 400.0 + 40.0 * k,
               "reserved_mb": 1000.0 + 10.0 * k} for k in range(20)]
    assert soak.memory_gate(rising[5], rising[7], gulp) == []
    assert len(soak.memory_gate(rising[5], rising[15], gulp)) == 2


def _pre_break_packets(cfg) -> tuple[bytes, bytes]:
    part = pk.encode_corr_part(
        pk.CorrPartHeader(sync_time=0, spectra_id=0, bw_hz=1.0,
                          sfreq_hz=1.0, acc_len=cfg.acc_len, nvis=1,
                          nchans=1, chan0=0),
        np.zeros((1, 2, 2), np.uint32), np.zeros((1, 1, 2), np.int32))
    corr = pk.encode_corr_full(
        pk.CorrFullHeader(sync_time=0, spectra_id=0, bw_hz=1.0, sfreq_hz=1.0,
                          acc_len=cfg.acc_len_slow, nchans=1, chan0=0,
                          npols=2, stand0=0, stand1=0),
        np.zeros((2, 2, 1, 2), np.int32))
    return part, corr


@pytest.mark.parametrize("leg", ["xb", "full"])
def test_no_packets_after_the_break_fail_the_post_break_check(short, leg):
    _, obs = short[leg]
    cfg = obs["cfg"]
    base = (obs["n_a"] + soak.GAP_GULPS) * cfg.ntime_gulp
    cut = copy.deepcopy({k: v for k, v in obs.items() if k != "frames"})
    cut["frames"] = obs["frames"]
    part, corr = _pre_break_packets(cfg)
    cut["rx"]["part"]["last_pkt"] = part
    cut["rx"]["corr"]["last_pkt"] = corr
    cut["rx"]["part"]["windows"] = {
        s: n for s, n in obs["rx"]["part"]["windows"].items() if s < base}
    cut["slow_seq0"] = [s for s in obs["slow_seq0"] if s < base]
    cut["slow_exact"] = obs["slow_exact"][:len(cut["slow_seq0"])]
    failures = soak.check_leg(cut)
    assert any(f.startswith("post-break") for f in failures), failures
    if leg == "full":
        assert any("0 after" in f for f in failures), failures


def test_full_truth_matches_jax():
    """The full leg's five gulps through the JAX correlator on the CPU,
    beside the port's plain path: equal integers (at the small shape; the
    same generator makes the full-width gulps)."""
    jnp = pytest.importorskip("jax.numpy")
    from caltech_bifrost_dsp_tpu.ops import correlate as jcorr

    cfg = SMALL_FULL
    frames = soak.make_frames("full", cfg)
    assert frames.shape == (5, cfg.ntime_gulp, cfg.nchan, cfg.ninput)
    re, im = soak.full_truth(cfg, frames, "cpu")
    want = jcorr.correlate_accumulate(
        jnp.asarray(frames.reshape(-1, cfg.nchan, cfg.ninput)),
        cfg.ntime_gulp)
    np.testing.assert_array_equal(re, np.asarray(want.real))
    np.testing.assert_array_equal(im, np.asarray(want.imag))
    # a window of the same five gulps in another phase sums the same
    shifted = soak.full_truth(cfg, np.roll(frames, 2, axis=0), "cpu")
    np.testing.assert_array_equal(shifted[0], re)
    np.testing.assert_array_equal(shifted[1], im)


def test_segments_follow_the_jax_gate():
    """``tests/test_soak.py:136-144`` at its defaults: 30 s at 8 gulps a
    second is 120 + 120 gulps; a short run still clears the margins."""
    assert soak.segments(TINY, 30.0, 8.0) == (120, 120)
    assert soak.segments(soak.FX_CFG, 30.0, 6.0) == (90, 90)
    cfg, reduced = soak.leg_config("full")
    assert (cfg.ninput, cfg.nchan, cfg.ntime_gulp, cfg.acc_len,
            cfg.acc_len_slow) == (704, 192, 480, 2400, 48_000)
    assert cfg.gulp_nbyte == 64_880_640 and len(reduced) == 1
    n_a, n_b = soak.segments(cfg, 900.0, 1.0)
    assert (n_a, n_b) == (450, 455)


def test_write_record_merges_legs(tmp_path):
    path = str(tmp_path / "soak.json")
    soak.write_record(path, "xb", {"pass": True})
    soak.write_record(path, "full", {"pass": False})
    soak.write_record(path, "xb", {"pass": False})
    assert json.loads(Path(path).read_text()) == {
        "full_leg": {"pass": False}, "xb_leg": {"pass": False}}


def test_soak_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "caltech_bifrost_dsp_tpu_torch.scripts.soak",
         "--leg", "xb", "--seconds", "1"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stderr


def test_blaster_back_to_back_feeds_the_capture():
    """``soak_wire.blast`` with no pace, as ``chip_smoke.py``'s wire path
    runs it: each frame once at sequence 0, ntime_gulp, ..., then two
    gulps that release the last; the capture gets every gulp whole."""
    cfg = TINY
    frames = np.random.default_rng(3).integers(
        0, 256, (3, cfg.ntime_gulp, cfg.nchan, cfg.ninput), dtype=np.uint8)
    shm = shared_memory.SharedMemory(create=True, size=frames.nbytes)
    port = soak.free_port()
    src = native.CaptureSource(cfg, "127.0.0.1", port, nbuf=8, poll_s=5.0)
    conn, child = multiprocessing.Pipe()
    try:
        np.ndarray(frames.shape, np.uint8, buffer=shm.buf)[...] = frames
        th = threading.Thread(target=soak_wire.blast, args=(
            child, shm.name, frames.shape, port, 16, 8, 20_000, None, 3))
        th.start()
        assert conn.poll(60) and conn.recv() == "ready"
        conn.send("go")
        dest = np.zeros(cfg.gulp_nbyte, np.uint8)
        for k, frame in enumerate(frames):
            assert src.fill_into(dest) == k * cfg.ntime_gulp
            np.testing.assert_array_equal(dest.reshape(frame.shape), frame)
        th.join(60)
        npkt, _ = conn.recv()
        assert npkt == 5 * cfg.ntime_gulp * (cfg.nchan // 16) * (
            cfg.ninput // 8)
        assert src.stats()["nmissing"] == 0
    finally:
        src.close()
        shm.close()
        shm.unlink()


def test_recvmmsg_binding_reads_into_slots():
    """``soak_wire.MMsgVec``: one ``recvmmsg`` fills consecutive slots,
    from a given slot on; a datagram longer than its slot reads as None;
    the timeout returns no datagram."""
    sock = soak_wire.bind_loopback(0.2)
    buf = ctypes.create_string_buffer(4 * 64)
    msgs = soak_wire.MMsgVec(ctypes.addressof(buf), 4, 64)
    sent = [bytes([k]) * (10 + k) for k in range(2)] + [b"x" * 100]
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as tx:
        for d in sent:
            tx.sendto(d, sock.getsockname())
        time.sleep(0.2)
        assert msgs.recv(sock, 1, 3) == 3
    try:
        assert [msgs.datagram(k) for k in (1, 2)] == sent[:2]
        assert msgs.datagram(3) is None
        assert msgs.length(1) == 10
        assert msgs.recv(sock, 0, 4) <= 0
    finally:
        sock.close()
