"""The port's wire path end to end, beside the JAX package's:

- ``CorrFullOutput(native_dest=...)``: the C++ packetizer's packets over
  loopback, in both wire formats and with a rate cap, byte-identical to
  the JAX sink's native packets and to the port's Python encoder; the
  autocorrelation file written before the send; a library that cannot be
  loaded raises instead of falling back.
- golden vectors -> C++ snap2 blaster -> ``native.CaptureSource`` ->
  ``XEnginePipeline(device="cpu")`` -> ``CorrFullOutput(native_dest=...,
  checkfile=...)`` -> a loopback receiver: the packets equal the JAX
  pipeline's over the same path, and scatter to the golden correlation
  (the analog of ``tests/test_over_the_wire.py``).
- the CLI without ``--fakesource`` on ``--device cpu`` against a blaster
  (exit 0, every fast dump equal to the numpy correlator, COR packets
  received), and ``--fx`` capture refusing float32 ADC with the JAX CLI's
  message; int8 ADC frames over UDP (``AdcCaptureSource``) give the dumps
  of the same samples fed in process (``tests/test_fx_udp.py``).

Every UDP port is one the operating system hands out.
"""

import dataclasses
import logging
import signal
import socket
import threading

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as jconfig
from caltech_bifrost_dsp_tpu.io import native as jnative
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.runtime.driver import XEnginePipeline as JPipe
from caltech_bifrost_dsp_tpu.scripts import pipeline as jcli
from caltech_bifrost_dsp_tpu_torch import config as tconfig
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.io import native
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io import source
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.scripts import pipeline
from caltech_bifrost_dsp_tpu_torch.utils import proclog
from caltech_bifrost_dsp_tpu_torch.verification import golden

JCFG = jconfig.XEngineConfig(nstand=16, nchan=32, ntime_gulp=48, acc_len=96,
                             acc_len_slow=96, nbeam=4, ntime_sum=12,
                             npipeline=2)
CFG = tconfig.XEngineConfig(**dataclasses.asdict(JCFG))
NBL = CFG.nstand * (CFG.nstand + 1) // 2
SYNC = 1_700_000_000


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Receiver(threading.Thread):
    """Every datagram to a loopback port until stopped."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=16,
                                       timeout_s=0.1)
        self.addr = self.sock.getsockname()
        self.pkts = []
        self.done = threading.Event()
        self.start()

    def run(self):
        while True:
            try:
                self.pkts.append(self.sock.recv(65536))
            except OSError:
                if self.done.is_set():
                    return

    def stop(self) -> list:
        self.done.set()
        self.join()
        self.sock.close()
        return self.pkts


def planes(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(-2 ** 31, 2 ** 31, (CFG.nchan, CFG.ninput,
                                             CFG.ninput), dtype=np.int64)
            .astype(np.int32) for _ in range(2)]


@pytest.mark.parametrize("cor_fmt,max_mbps", [(False, -1), (True, -1),
                                              (True, 400)])
def test_native_sink_matches_jax_sink_and_python(tmp_path, cor_fmt,
                                                 max_mbps):
    vr, vi = planes(3 + cor_fmt)
    rx = {"port": Receiver(), "jax": Receiver()}
    port_out = sink.CorrFullOutput(CFG, native_dest=rx["port"].addr,
                                   max_mbps=max_mbps, use_cor_fmt=cor_fmt)
    jax_out = jsink.CorrFullOutput(JCFG, native_dest=rx["jax"].addr,
                                   max_mbps=max_mbps, use_cor_fmt=cor_fmt)
    assert jnative.available()
    # the autos go out before the send; the JAX sink's native branch
    # cannot write them (a local numpy import shadows its module's), so
    # they are held to the port's Python branch
    port_out.autos_path = str(tmp_path / "native")
    (tmp_path / "native").mkdir()
    for out in (port_out, jax_out):
        assert out.send_matrix_planes(vr, vi, SYNC, 480, 96) == NBL
    got = {name: r.stop() for name, r in rx.items()}
    py = []
    python_out = sink.CorrFullOutput(CFG, send=py.append, use_cor_fmt=cor_fmt)
    python_out.autos_path = str(tmp_path / "python")
    (tmp_path / "python").mkdir()
    python_out.send_matrix_planes(vr, vi, SYNC, 480, 96)
    assert len(got["port"]) == len(got["jax"]) == len(py) == NBL
    assert sorted(got["port"]) == sorted(got["jax"]) == sorted(py)
    np.testing.assert_array_equal(
        np.load(tmp_path / "native" / "autos_480.npy"),
        np.load(tmp_path / "python" / "autos_480.npy"))


def test_native_dest_raises_when_the_library_fails(monkeypatch):
    """No silent fallback to the Python encoder: a library that cannot
    be built or loaded fails the sink's construction."""
    def broken():
        raise OSError("cannot load the native library")

    monkeypatch.setattr(native, "load", broken)
    with pytest.raises(OSError, match="native library"):
        sink.CorrFullOutput(CFG, native_dest=("127.0.0.1", free_port()))
    # without native_dest nothing is loaded
    sink.CorrFullOutput(CFG, send=[].append)


def cube(pkts, cor_fmt: bool) -> dict:
    """Packets -> {spectra_id: int64 [s0, s1, p0, p1, chan, 2]}, both
    triangles (the mirror conjugated)."""
    sps = int(round(CFG.fs_hz / CFG.chan_bw_hz))
    dumps = {}
    for p in pkts:
        if cor_fmt:
            hdr, data = pk.decode_cor(p)
            key, i, j = hdr.time_tag // sps, hdr.stand_i - 1, hdr.stand_j - 1
            data = data.transpose(1, 2, 0, 3)
        else:
            hdr, data = pk.decode_corr_full(p)
            key, i, j = hdr.spectra_id, hdr.stand0, hdr.stand1
        out = dumps.setdefault(key, np.zeros(
            (CFG.nstand, CFG.nstand, CFG.npol, CFG.npol, CFG.nchan, 2),
            np.int64))
        out[i, j] = data
        mirror = data.transpose(1, 0, 2, 3).astype(np.int64)
        mirror[..., 1] *= -1
        out[j, i] = mirror
    return dumps


def blaster(port, din, ngulp, mod=native):
    def blast():
        for g in range(ngulp + 2):  # 2 gulps of slack flush the lead
            idx = min(g, ngulp - 1)
            mod.transmit_gulp(
                "127.0.0.1", port, np.ascontiguousarray(
                    din[idx * CFG.ntime_gulp:(idx + 1) * CFG.ntime_gulp]),
                seq0=g * CFG.ntime_gulp, nchan_per_pkt=16, npol_per_pkt=8,
                delay_ns=20000)

    return threading.Thread(target=blast, daemon=True)


@pytest.mark.parametrize("cor_fmt", [False, True])
def test_wire_end_to_end_matches_jax_and_golden(tmp_path, cor_fmt):
    ntime = 2 * CFG.acc_len_slow
    in_path, corr_path = str(tmp_path / "in.dat"), str(tmp_path / "corr.dat")
    golden.write_input_file(in_path, ntime, CFG.nchan, CFG.nstand, CFG.npol,
                            CFG.acc_len)
    golden.write_corr_file(corr_path, ntime, CFG.nchan, CFG.nstand,
                           CFG.npol, CFG.acc_len)
    _, din = golden.read_dat(in_path)
    din = din.reshape(ntime, CFG.nchan, CFG.ninput)
    ngulp = ntime // CFG.ntime_gulp
    runs = {}
    for name, mod, sk, Pipe, cfg in (
            ("port", native, sink, XEnginePipeline, CFG),
            ("jax", jnative, jsink, JPipe, JCFG)):
        rx = Receiver()
        port = free_port()
        cap = mod.CaptureSource(cfg, "127.0.0.1", port, nbuf=16, poll_s=20.0)
        out = sk.CorrFullOutput(cfg, native_dest=rx.addr, use_cor_fmt=cor_fmt,
                                checkfile=corr_path,
                                checkfile_acc_len=cfg.acc_len)
        kw = {"device": "cpu"} if name == "port" else {}
        pipe = Pipe(cfg, cap, corr_outputs=[out], sync_time=SYNC, **kw)
        tx = blaster(port, din, ngulp, mod)
        tx.start()
        try:
            pipe.run(ngulp, timeout_s=120)
        finally:
            tx.join(timeout=30)
            stats = cap.stats()
            cap.close()
        runs[name] = (rx.stop(), out, pipe, stats)
    (ppk, pout, ppipe, pstats), (jpk_, jout, jpipe, _) = \
        runs["port"], runs["jax"]
    assert pstats["nmissing"] == 0
    assert ppipe.ndump_slow == jpipe.ndump_slow == 2
    assert (pout.check_count, pout.check_failures) == (2, 0)
    assert (jout.check_count, jout.check_failures) == (2, 0)
    assert len(ppk) == 2 * NBL
    assert sorted(ppk) == sorted(jpk_)
    blocks = list(golden.generate_input_blocks(
        ntime, CFG.nchan, CFG.nstand, CFG.npol, CFG.acc_len))
    for spectra_id, got in cube(ppk, cor_fmt).items():
        want = golden.reference_correlation(
            blocks[spectra_id // CFG.acc_len]).transpose(1, 2, 3, 4, 0)
        np.testing.assert_array_equal(got[..., 0], want.real)
        np.testing.assert_array_equal(got[..., 1], want.imag)


def test_cli_captures_without_fakesource_on_cpu(tmp_path, capsys):
    """The CLI binds the capture itself; the blaster sends the golden
    stream until the CLI returns.  ``--testcorr`` holds every fast dump
    to a numpy correlator of the bytes captured."""
    port = free_port()
    rx = Receiver()
    ntime = 8 * CFG.ntime_gulp
    din = np.concatenate(list(golden.generate_input_blocks(
        ntime, CFG.nchan, CFG.nstand, CFG.npol, CFG.acc_len))).reshape(
        ntime, CFG.nchan, CFG.ninput)
    done = threading.Event()

    def blast():
        g = 0
        while not done.is_set():
            k = g % 8
            native.transmit_gulp(
                "127.0.0.1", port, np.ascontiguousarray(
                    din[k * CFG.ntime_gulp:(k + 1) * CFG.ntime_gulp]),
                seq0=g * CFG.ntime_gulp, nchan_per_pkt=16, npol_per_pkt=8,
                delay_ns=200_000)
            g += 1

    tx = threading.Thread(target=blast, daemon=True)
    tx.start()
    # the CLI runs until --ngulp gulps arrive: a stalled capture is ended
    # through the CLI's own SIGTERM handler (sent to the main thread, whose
    # join it interrupts) instead of hanging the suite
    watchdog = threading.Timer(120.0, signal.pthread_kill, (
        threading.main_thread().ident, signal.SIGTERM))
    watchdog.start()
    try:
        rc = pipeline.main([
            "--ip", "127.0.0.1", "--port", str(port), "--nstand", "16",
            "--nchan", "32", "--nbeam", "4", "--ntime_gulp", "48",
            "--acc_len", "96", "--acc_len_slow", "96", "--ngulp", "8",
            "--device", "cpu", "--testcorr", "--cor-fmt", "--corr-dest",
            f"{rx.addr[0]}:{rx.addr[1]}", "-q"])
    finally:
        watchdog.cancel()
        done.set()
        tx.join(timeout=30)
    pkts = rx.stop()
    out = capsys.readouterr().out
    assert rc == 0
    nfail = out.split("selftest: ")[1].split()[0]
    npass, ntotal = map(int, nfail.split("/"))
    assert npass == ntotal >= 1
    assert pkts and len(pkts) % NBL == 0
    for dump in cube(pkts, True).values():
        # Hermitian, and the autos real and non-negative
        np.testing.assert_array_equal(dump[..., 0],
                                      dump.transpose(1, 0, 3, 2, 4, 5)[..., 0])
        idx = np.arange(CFG.nstand)
        assert (dump[idx, idx, [0], [0], :, 1] == 0).all()
        assert (dump[idx, idx, [0], [0], :, 0] >= 0).all()


def test_cli_fx_capture_refuses_float32_like_jax():
    argv = ["--nstand", "8", "--nchan", "32", "--nbeam", "4", "--ntime_gulp",
            "48", "--acc_len", "96", "--acc_len_slow", "192", "--fx",
            "--port", str(free_port()), "--ip", "127.0.0.1"]
    with pytest.raises(SystemExit) as mine:
        pipeline.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as theirs:
        jcli.build_pipeline(jcli.build_parser().parse_args(argv),
                            logging.getLogger("t"))
    assert str(mine.value) == str(theirs.value)
    assert "int8" in str(mine.value)


def test_fx_udp_adc_matches_inprocess_source():
    """int8 ADC frames over the snap2 wire (AdcCaptureSource) through the
    FX pipeline: the dumps of the same samples fed in process, 0 lost."""
    cfg = CFG.replace(nstand=8, acc_len_slow=192, nchan_sum=4, pfb_ntap=4,
                      adc_dtype="int8", pfb_fft_impl="matmul")
    L = 2 * cfg.nchan
    ngulp = cfg.acc_len_slow // cfg.ntime_gulp
    port = free_port()
    src = native.AdcCaptureSource(cfg, "127.0.0.1", port)
    gen = source.ADCSource(cfg, mode="tone", tone_chan=9, amplitude=50.0)

    def tx():
        for i in range(ngulp):
            frames = gen.gulp(i).reshape(cfg.ntime_gulp, L, cfg.ninput)
            native.transmit_gulp("127.0.0.1", port, frames.view(np.uint8),
                                 seq0=i * cfg.ntime_gulp, nchan_per_pkt=L,
                                 npol_per_pkt=cfg.ninput, delay_ns=20_000)

    th = threading.Thread(target=tx)
    udp = sink.ProductKeeper()
    pipe = XEnginePipeline(cfg, src, corr_outputs=[udp], quant_scale=0.2,
                           fx_mode=True, device="cpu")
    th.start()
    try:
        pipe.run(ngulp, timeout_s=300)
    finally:
        th.join(timeout=30)
        stats = src.stats()
        src.close()
    assert stats["nmissing"] == 0
    here = sink.ProductKeeper()
    XEnginePipeline(cfg, source.ADCSource(cfg, mode="tone", tone_chan=9,
                                          amplitude=50.0),
                    corr_outputs=[here], quant_scale=0.2, fx_mode=True,
                    device="cpu").run(ngulp, timeout_s=300)
    assert len(udp.slow) == len(here.slow) == 1
    (got,), (want,) = udp.slow.values(), here.slow.values()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert np.diagonal(got[0], axis1=1, axis2=2)[:, 0].argmax() == 9
