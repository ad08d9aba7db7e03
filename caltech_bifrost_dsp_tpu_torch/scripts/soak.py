"""Long-run soak of the port's driver: the harness of the JAX package's
soak gate (``tests/test_soak.py``), with a leg at full LWA-352 width.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.soak --leg full \\
        --seconds 900 --record SOAK_torch.json

A leg runs :class:`XEnginePipeline` fed by ``native.CaptureSource`` (or
``AdcCaptureSource``) from a snap2 blaster in a process of its own, paced
at ``--rate`` gulps a second, with every output stream live over loopback
UDP to a receiver process per stream, a 1000-gulp sequence break half way
through, a triggered dump commanded through the control client and
replayed from its file, and the monitor bridge publishing.  Every 5 s it
samples the host RSS and, on the card, ``memory_allocated``,
``memory_reserved`` and the pinned host allocator.

Legs:

- ``xb``: ``config.TINY`` at 8 gulps a second, one random gulp repeated;
  the JAX X/B leg's checks (fast dumps from both segments, the subselection
  and the slow stream past the break, every stream flowing).
- ``fx``: the JAX FX leg's 8-stand int8 configuration at 6 gulps a second,
  four tone gulps repeated; a slow dump on each side of the break with the
  tone in its channel.
- ``full``: ``config.LWA352`` (704 inputs x 192 channels, 480-sample gulps
  of 64.9 MB, 2400-spectra fast windows) with ``acc_len_slow`` cut from
  240 000 to 48 000 spectra (20 fast windows); five seeded gulps repeated,
  so every fast window sums the same five gulps whatever its phase and
  each product has one truth, computed once by the plain correlator.
  Every fast window's subselection, decoded from its packets, and every
  slow dump, taken in process beside the UDP sink, must equal it exactly
  (a slow dump 20 times the fast one) on both sides of the break; a
  10-frame history ring (649 MB).

Gates, every leg: no packet missing from a gulp and a second sequence
after the break; the dump file replays (at full width: equal to the gulp
sent at its ``seq0``); the monitor publishes; every stream has packets and
kept them coming near the end; after the quarter mark (a quarter of the
gulps sent and at least two slow dumps delivered) the RSS high-water grows
by less than 300 MB and, on the card, ``memory_reserved`` at the end is at
most its value at the quarter mark plus one gulp.  The run prints one JSON
line (the JAX record's keys plus the card, the commit, what was cut and
the device trajectory), merges it into ``--record`` under ``<leg>_leg`` and
exits 1 on any failed gate.  ``--device cuda`` without a card exits 2.
"""

from __future__ import annotations

import argparse
import fcntl
import glob
import json
import multiprocessing
import os
import resource
import shutil
import socket
import sys
import tempfile
import threading
import time
from multiprocessing import shared_memory
from typing import Callable

import numpy as np
import torch

from ..config import LWA352, TINY, XEngineConfig
from ..control.client import CorrControlClient, PipelineControl
from ..control.command import CommandBlock
from ..control.monitor import MonitorBridge
from ..control.store import MemoryStore
from ..io import native, sink
from ..io import packets as pk
from ..io.source import ADCSource, SyntheticSource, TriggerFileSource
from ..ops import corr_subsel as cs
from ..ops.correlate import Vis, chan_major, correlate_chan_major
from ..ops.kernels import _build
from ..runtime.driver import XEnginePipeline
from ..utils.roofline import card_fields, current_commit
from . import soak_wire

LEGS = ("xb", "fx", "full")
#: the JAX FX leg's configuration (``tests/test_soak.py:89-92``)
FX_CFG = XEngineConfig(
    nstand=8, nchan=16, ntime_gulp=48, acc_len=240, acc_len_slow=240,
    nbeam=2, ntime_sum=12, nchan_sum=4, pfb_ntap=4, adc_dtype="int8",
    pfb_fft_impl="matmul")
TONE = 5
#: the full leg's one cut: slow dumps of 20 fast windows, not 100
FULL_ACC_LEN_SLOW = 48_000
#: gulps a second offered: the JAX legs' paces; at full width half the
#: 1.29 Gb/s at which the every-sink driver fed by native capture kept up
#: in chip_smoke.py's wire path on an H100 (PERF.md section 4)
RATES = {"xb": 8.0, "fx": 6.0, "full": 1.24}
#: frames the blaster cycles through
NFRAME = {"xb": 1, "fx": 4, "full": 5}
#: history ring frames (gulps as ingested)
NHISTORY = {"xb": 32, "fx": 32, "full": 10}
GAP_GULPS = 1000
#: the blaster's frames: xb the JAX leg's RandomState(7) gulp, full a
#: default_rng(7) draw of five
SEED = 7
#: the UDP COR sink's rate cap, Mb/s: none, as chip_smoke.py's wire path
#: settles on (every packet arrived uncapped)
COR_MBPS = -1
RSS_GROWTH_MB = 300.0
SAMPLE_S = 5.0
#: burst rate of a full-width gulp's packets, Gb/s (paced by delay_ns)
FULL_BURST_GBPS = 2.0
STREAMS = {"xb": ("corr", "part", "pbeam", "ibeam"), "fx": ("corr",),
           "full": ("corr", "part", "pbeam", "ibeam")}


def leg_config(leg: str, acc_len_slow: int | None = None
               ) -> tuple[XEngineConfig, list]:
    """The leg's configuration and the list of what was cut from its
    source configuration."""
    cfg = {"xb": TINY, "fx": FX_CFG,
           "full": LWA352.replace(acc_len_slow=FULL_ACC_LEN_SLOW)}[leg]
    if acc_len_slow is not None:
        cfg = cfg.replace(acc_len_slow=acc_len_slow)
    reduced = []
    if leg == "full":
        reduced.append(f"acc_len_slow {LWA352.acc_len_slow} -> "
                       f"{cfg.acc_len_slow} spectra "
                       f"({cfg.acc_len_slow // cfg.acc_len} fast windows)")
    elif acc_len_slow is not None:
        reduced.append(f"acc_len_slow -> {cfg.acc_len_slow} spectra")
    return cfg, reduced


def segments(cfg: XEngineConfig, seconds: float, rate: float
             ) -> tuple[int, int]:
    """Gulps before and after the break (``tests/test_soak.py:136-144``):
    half the run each, segment A long enough for two slow dumps and
    segment B past the recovery margins (10 fast windows, 2 slow windows)
    and one slow window to dump."""
    gpa = cfg.acc_len // cfg.ntime_gulp
    total = max(int(seconds * rate), 16 * gpa)
    n_a = max(total // 2, 2 * cfg.acc_len_slow // cfg.ntime_gulp + gpa)
    n_b_min = (11 * cfg.acc_len + 4 * cfg.acc_len_slow) // cfg.ntime_gulp
    return n_a, max(total - n_a, n_b_min)


def raw_gulp_nbyte(cfg: XEngineConfig, fx: bool) -> int:
    """Bytes of one gulp as ingested: packed, or int8 ADC."""
    return cfg.gulp_nbyte * (2 * cfg.adc_np_dtype.itemsize if fx else 1)


def make_frames(leg: str, cfg: XEngineConfig) -> np.ndarray:
    """The gulps the blaster cycles through, uint8 [nframe, ntime_gulp,
    nchan (2 nchan ADC samples for FX), ninput]."""
    if leg == "fx":
        gen = ADCSource(cfg, mode="tone", tone_chan=TONE, amplitude=50.0)
        return np.stack([gen.gulp(i).reshape(
            cfg.ntime_gulp, 2 * cfg.nchan, cfg.ninput).view(np.uint8)
            for i in range(NFRAME[leg])])
    shape = (cfg.ntime_gulp, cfg.nchan, cfg.ninput)
    if leg == "xb":
        return np.random.RandomState(SEED).randint(
            0, 256, shape).astype(np.uint8)[None]
    return np.random.default_rng(SEED).integers(
        0, 256, (NFRAME[leg],) + shape, dtype=np.uint8)


def full_truth(cfg: XEngineConfig, frames: np.ndarray, device
               ) -> tuple[np.ndarray, np.ndarray]:
    """The fast window's visibilities, int32 planes [nchan, ninput,
    ninput]: the plain correlator over one of each frame (a window of
    ``len(frames)`` gulps sums each once)."""
    if len(frames) * cfg.ntime_gulp != cfg.acc_len:
        raise ValueError("a fast window must hold each frame once")
    packed = torch.from_numpy(frames.reshape(-1, cfg.nchan,
                                             cfg.ninput)).to(device)
    vis = correlate_chan_major(chan_major(packed, "tci"))
    out = vis.real.cpu().numpy(), vis.imag.cpu().numpy()
    del packed, vis
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def subsel_truth(cfg: XEngineConfig, fast: tuple, baselines
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The subselection of the fast truth (plain gather on the host)."""
    pairs = torch.from_numpy(cs.baselines_to_inputs(
        baselines, cfg.npol).astype(np.int32))
    sub = cs.corr_subsel_ref(Vis(*(torch.from_numpy(p) for p in fast)),
                             pairs, cfg.nchan_sum)
    return sub.real.numpy(), sub.imag.numpy()


def slow_dump_exact(vis_re, vis_im, fast: tuple, nwin: int,
                    chunk: int = 16) -> bool:
    """Whether a slow dump's planes equal ``nwin`` times the fast truth,
    compared ``chunk`` channels at a time."""
    for c0 in range(0, fast[0].shape[0], chunk):
        c1 = c0 + chunk
        for got, want in zip((vis_re, vis_im), fast):
            if not np.array_equal(got[c0:c1], want[c0:c1] * np.int32(nwin)):
                return False
    return True


def memory_gate(quarter: dict | None, end: dict, gulp_nbyte: int
                ) -> list[str]:
    """Failures of the memory gates: RSS high-water growth after the
    quarter mark under 300 MB; on the card, ``memory_reserved`` at the end
    at most its quarter-mark value plus one gulp."""
    if quarter is None:
        return ["memory: no quarter mark (two slow dumps never came)"]
    out = []
    growth = end["rss_highwater_mb"] - quarter["rss_highwater_mb"]
    if not growth < RSS_GROWTH_MB:
        out.append(f"memory: RSS high-water grew {growth:.1f} MB after the "
                   f"quarter mark (limit {RSS_GROWTH_MB})")
    if quarter.get("reserved_mb") is not None:
        limit = quarter["reserved_mb"] + gulp_nbyte / 1e6
        if end["reserved_mb"] > limit:
            out.append(f"memory: memory_reserved {end['reserved_mb']:.1f} "
                       f"MB at the end, over the quarter mark's "
                       f"{quarter['reserved_mb']:.1f} + one gulp")
    return out


class MemorySampler:
    """Every ``period_s``: host RSS (``/proc/self/statm``) and, on the
    card, ``memory_allocated``, ``memory_reserved`` and the bytes of the
    pinned host allocator's pool (``torch.cuda.host_memory_stats``, where
    this torch has it), all MB."""

    def __init__(self, cuda: bool, period_s: float = SAMPLE_S):
        self.cuda = cuda
        self.period_s = period_s
        self.rss: list = []
        self.device: list = []
        self._page = os.sysconf("SC_PAGESIZE")
        self._stop = threading.Event()
        self.t0 = time.monotonic()
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name="soak-memory")
        self.thread.start()

    def rss_mb(self) -> float:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * self._page / 1e6

    def snapshot(self) -> dict:
        snap = {"t_s": round(time.monotonic() - self.t0, 1),
                "rss_mb": round(self.rss_mb(), 1),
                "rss_highwater_mb": round(resource.getrusage(
                    resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1),
                "allocated_mb": None, "reserved_mb": None,
                "pinned_mb": None}
        if self.cuda:
            snap["allocated_mb"] = round(torch.cuda.memory_allocated() / 1e6,
                                         1)
            snap["reserved_mb"] = round(torch.cuda.memory_reserved() / 1e6, 1)
            stats = getattr(torch.cuda, "host_memory_stats", None)
            if stats is not None:
                # the pool's blocks, in use and cached (sizes rounded up to
                # powers of two)
                pinned = stats().get("allocated_bytes.current")
                if pinned is not None:
                    snap["pinned_mb"] = round(pinned / 1e6, 1)
        return snap

    def _loop(self):
        while not self._stop.is_set():
            s = self.snapshot()
            self.rss.append([s["t_s"], s["rss_mb"]])
            if self.cuda:
                self.device.append([s["t_s"], s["allocated_mb"],
                                    s["reserved_mb"], s["pinned_mb"]])
            self._stop.wait(self.period_s)

    def stop(self) -> None:
        self._stop.set()
        self.thread.join(timeout=self.period_s + 5)


class SlowGrab:
    """A slow-dump sink beside the UDP one (as the JAX FX leg's): of every
    dump handed to it the ``seq0``, the channel where the first input's
    autocorrelation peaks (the FX leg's tone), and with ``truth`` whether
    it equals ``nwin`` times the fast truth."""

    checkfile = None

    def __init__(self, truth: tuple | None = None, nwin: int = 0):
        self.truth, self.nwin = truth, nwin
        self.seq0: list = []
        self.peak: list = []
        self.exact: list = []

    def send_matrix_planes(self, vis_re, vis_im, sync_time, spectra_id,
                           acc_len) -> int:
        if self.truth is not None:
            self.exact.append(slow_dump_exact(vis_re, vis_im, self.truth,
                                              self.nwin))
        self.peak.append(int(np.argmax(vis_re[:, 0, 0])))
        self.seq0.append(spectra_id)
        return 0


class Receiver:
    """One product stream's receiver (:func:`.soak_wire.receive`) in a
    process of its own, started here; :meth:`ready` waits for its
    socket."""

    def __init__(self, ctx, kind: str, truth=None):
        self.kind = kind
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=soak_wire.receive, daemon=True,
                                args=(child, kind, truth),
                                name=f"soak-rx-{kind}")
        self.proc.start()

    def ready(self) -> None:
        if not self.conn.poll(120):
            raise RuntimeError(f"{self.kind} receiver did not start")
        port, self.rcvbuf = self.conn.recv()
        self.addr = ("127.0.0.1", port)

    def collect(self) -> dict:
        self.conn.send("stop")
        if not self.conn.poll(120):
            raise RuntimeError(f"{self.kind} receiver did not finish")
        out = self.conn.recv()
        self.proc.join(10)
        return out


class Blaster:
    """The blaster (:func:`.soak_wire.blast`) in a process of its own,
    its frames in shared memory, started here; :meth:`ready` waits for
    it."""

    def __init__(self, ctx, frames: np.ndarray, port: int,
                 nchan_per_pkt: int, npol_per_pkt: int, delay_ns: int,
                 rate: float, n_a: int, n_b: int):
        self.shm = shared_memory.SharedMemory(create=True,
                                              size=frames.nbytes)
        np.ndarray(frames.shape, np.uint8, buffer=self.shm.buf)[...] = frames
        self.sent = ctx.Value("q", 0, lock=False)
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=soak_wire.blast, daemon=True, args=(
            child, self.shm.name, frames.shape, port, nchan_per_pkt,
            npol_per_pkt, delay_ns, rate, n_a, n_b, GAP_GULPS, self.sent),
            name="soak-blaster")
        self.proc.start()

    def ready(self) -> None:
        if not (self.conn.poll(120) and self.conn.recv() == "ready"):
            raise RuntimeError("blaster did not start")

    def go(self) -> None:
        self.conn.send("go")

    def finish(self, timeout_s: float = 60.0):
        """(packets, seconds) once the blaster is done; stops it first if
        it is still sending."""
        if self.proc.is_alive() and not self.conn.poll(0):
            self.conn.send("stop")
        result = self.conn.recv() if self.conn.poll(timeout_s) else None
        self.proc.join(10)
        if self.proc.is_alive():
            self.proc.terminate()
        self.shm.close()
        self.shm.unlink()
        return result


def packet_params(leg: str, cfg: XEngineConfig) -> tuple[int, int, int]:
    """(nchan_per_pkt, npol_per_pkt, delay_ns) of the blaster: the JAX
    legs' (20 us every 16 time samples), and at full width 8-channel
    packets of every input paced to ``FULL_BURST_GBPS``."""
    if leg == "xb":
        return 16, 8, 20_000
    if leg == "fx":
        return 2 * cfg.nchan, cfg.ninput, 20_000
    return min(8, cfg.nchan), cfg.ninput, int(
        16 * cfg.nchan * cfg.ninput * 8 / FULL_BURST_GBPS)


def warm(leg: str, cfg: XEngineConfig, device) -> None:
    """Two windows through an in-process pipeline before the paced run,
    so that no first call's latency overruns the capture's slots."""
    fx = leg == "fx"
    if fx:
        src = ADCSource(cfg, mode="tone", tone_chan=TONE, amplitude=50.0)
    else:
        src = SyntheticSource(cfg, mode="random", skip_write=leg == "full")
    pipe = XEnginePipeline(cfg, src, fx_mode=fx, quant_scale=0.2,
                           corr_outputs=[SlowGrab()],
                           subsel_outputs=[sink.CorrPartOutput(cfg)],
                           device=device)
    pipe.run(2 * cfg.acc_len // cfg.ntime_gulp, timeout_s=600)


def _gulp_index(seq0: int, ntime_gulp: int, n_a: int) -> int:
    """The stream index of the gulp at ``seq0``, inverse of
    :func:`.soak_wire.stream_seq`."""
    g = seq0 // ntime_gulp
    return g if g < n_a else g - GAP_GULPS


def run_leg(leg: str, seconds: float, rate: float | None = None,
            device: str = "cuda", acc_len_slow: int | None = None,
            dump_dir: str | None = None, cfg: XEngineConfig | None = None,
            on_start: Callable[[], None] | None = None) -> tuple[dict, dict]:
    """Run one leg; returns (record, observation).  The observation holds
    what :func:`check_leg` reads; the record's ``failures`` are its
    result.  ``cfg`` replaces the leg's configuration (a small shape for a
    test; the full leg needs ``acc_len == 5 * ntime_gulp`` and at least
    48 stands for the production selection).  ``on_start`` is called just
    before the paced run, after the warm-up pipeline (a caller that counts
    kernel launches zeroes its counts there)."""
    if leg not in LEGS:
        raise ValueError(f"unknown leg {leg!r}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("device cuda but no CUDA device is available")
    rate = RATES[leg] if rate is None else rate
    if cfg is None:
        cfg, reduced = leg_config(leg, acc_len_slow)
    else:
        reduced = [f"configuration {cfg.nstand} stands x {cfg.nchan} "
                   f"channels, gulps of {cfg.ntime_gulp} spectra"]
    fx = leg == "fx"
    n_a, n_b = segments(cfg, seconds, rate)
    frames = make_frames(leg, cfg)
    if cuda:
        _build.library()
    own_dir = dump_dir is None
    dump_dir = tempfile.mkdtemp(prefix="cbd-soak-") if own_dir else dump_dir
    ctx = multiprocessing.get_context("spawn")

    fast = sub = None
    baselines = cs.default_baselines(cfg.nvis_out, cfg.nstand)
    if leg == "full":
        baselines = cs.production_baselines(cfg.nvis_out, cfg.nstand,
                                            cfg.npol)
        fast = full_truth(cfg, frames, dev)
        sub = subsel_truth(cfg, fast, baselines)
    warm(leg, cfg, dev)

    sampler = MemorySampler(cuda)
    t_run0 = time.monotonic()
    rxs, blaster, cap = {}, None, None
    try:
        # a spawned process imports this program's main module first, so
        # all start before any is waited for
        port = free_port()
        for name in STREAMS[leg]:
            truth = (soak_wire.SubselTruth(*sub, baselines)
                     if name == "part" and sub is not None else None)
            rxs[name] = Receiver(ctx, name, truth)
        blaster = Blaster(ctx, frames, port, *packet_params(leg, cfg), rate,
                          n_a, n_b)
        for proc in (*rxs.values(), blaster):
            proc.ready()
        store = MemoryStore()
        capture_cls = native.AdcCaptureSource if fx else native.CaptureSource
        cap = capture_cls(cfg, "127.0.0.1", port, nbuf=64 if fx else 16,
                          poll_s=30.0)
        grab = SlowGrab(fast, cfg.acc_len_slow // cfg.acc_len)

        def udp(name):
            return sink.UdpSender(*rxs[name].addr)

        outs = {"corr_outputs": [grab, sink.CorrFullOutput(
            cfg, send=udp("corr"), max_mbps=COR_MBPS)]}
        if "part" in rxs:
            outs["subsel_outputs"] = [sink.CorrPartOutput(cfg,
                                                          send=udp("part"))]
            nbeam = cfg.nbeam // 2 if leg == "full" else 1
            pbeam = udp("pbeam")
            outs["pbeam_outputs"] = [sink.PBeamOutput(
                cfg, senders={b: pbeam for b in range(nbeam)})]
            outs["ibeam_outputs"] = [sink.IBeamOutput(cfg, send=udp("ibeam"))]
        # the blocks number their instances per process: this pipeline's
        # are instance 0, where the control client addresses them
        CommandBlock.reset_instance_counts()
        pipe = XEnginePipeline(
            cfg, cap, store=store, fx_mode=fx, quant_scale=0.2,
            history_nbyte=NHISTORY[leg] * raw_gulp_nbyte(cfg, fx),
            device=device, **outs)
        host = socket.gethostname()
        client = CorrControlClient(store=store, timeout_s=10.0)
        ctl = PipelineControl(client, host, 0)
        if leg == "full":
            client.send_command(host, 0, "CorrSubsel", baselines=baselines)
        ntotal = n_a + n_b
        trigger_at = n_a + n_b // 2 if leg == "full" else n_a // 2
        marks = {"quarter": None, "trigger_error": None}
        spf = cfg.ntime_gulp * (2 * cfg.nchan if fx else 1)

        def conduct():
            """Trigger the dump and take the quarter mark as the blaster's
            count passes them."""
            triggered = False
            while not (triggered and marks["quarter"]):
                if stop_conduct.wait(0.05):
                    return
                sent = blaster.sent.value
                if not triggered and sent >= trigger_at:
                    triggered = True
                    try:
                        ctl.triggered_dump.trigger(
                            ntime_per_file=spf, nfile=1, dump_path=dump_dir)
                    except Exception as e:  # noqa: BLE001 - a gate reads it
                        marks["trigger_error"] = repr(e)
                if (marks["quarter"] is None and sent >= ntotal // 4
                        and len(grab.seq0) >= 2):
                    marks["quarter"] = sampler.snapshot()

        stop_conduct = threading.Event()
        conductor = threading.Thread(target=conduct, daemon=True,
                                     name="soak-conductor")
        conductor.start()
        if on_start is not None:
            on_start()
        blaster.go()
        run_error = None
        try:
            pipe.run(ntotal, timeout_s=ntotal / rate + 180)
        except Exception as e:  # noqa: BLE001 - a failed gate, recorded
            run_error = repr(e)
        sent = blaster.finish()
        stop_conduct.set()
        conductor.join(10)
        stats = cap.stats()
        cap.close()
        cap = None
        time.sleep(1.5)  # the receivers drain the tail
        rx = {name: r.collect() for name, r in rxs.items()}
        end_t = time.monotonic()
        dump = replayed_dump(pipe, dump_dir)
        MonitorBridge(store, pipeline_id=0).publish_once()
        monitor_keys = len(store.get_prefix("/mon/"))
        sampler.stop()
        end = sampler.snapshot()
    finally:
        sampler.stop()
        if blaster is not None and blaster.proc.is_alive():
            blaster.finish(timeout_s=10)
        for r in rxs.values():
            if r.proc.is_alive():
                r.proc.terminate()
        if cap is not None:
            cap.close()
        if own_dir:
            shutil.rmtree(dump_dir, ignore_errors=True)

    duration = time.monotonic() - t_run0
    obs = {"leg": leg, "cfg": cfg, "n_a": n_a, "n_b": n_b,
           "seconds": seconds, "run_error": run_error, "stats": stats,
           "ndump_fast": pipe.ndump_fast, "ndump_slow": pipe.ndump_slow,
           "rx": rx, "end_t": end_t, "slow_seq0": list(grab.seq0),
           "slow_exact": list(grab.exact), "dump": dump,
           "trigger_error": marks["trigger_error"],
           "monitor_keys": monitor_keys, "quarter": marks["quarter"],
           "end": end, "frames": frames,
           "tone_chans": list(grab.peak), "fx": fx,
           "gulp_nbyte": raw_gulp_nbyte(cfg, fx)}
    failures = check_leg(obs)
    rec = record(obs, seconds, rate, duration, sampler, reduced, device,
                 sent, failures)
    return rec, obs


def free_port() -> int:
    """A UDP port the operating system reports free on 127.0.0.1."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def replayed_dump(pipe: XEnginePipeline, dump_dir: str,
                  timeout_s: float = 60.0) -> dict | None:
    """The triggered dump's first file once the dump block is idle,
    replayed through :class:`TriggerFileSource`: its header and data."""
    deadline = time.monotonic() + timeout_s
    files = []
    while time.monotonic() < deadline:
        files = sorted(glob.glob(os.path.join(dump_dir, "*.tbf")))
        if files and pipe.dump_cmd.stats.get("state") == "idle":
            break
        time.sleep(0.2)
    if not files:
        return None
    hdr, data = TriggerFileSource(files[0]).read()
    return {"file": os.path.basename(files[0]), "header": hdr,
            "data": np.array(data)}


def check_leg(obs: dict) -> list[str]:
    """Every gate of the leg on its observation; returns the failures."""
    cfg, leg = obs["cfg"], obs["leg"]
    n_a, n_b = obs["n_a"], obs["n_b"]
    base = (n_a + GAP_GULPS) * cfg.ntime_gulp
    out = []
    if obs["run_error"]:
        out.append(f"pipeline: {obs['run_error']}")
    stats = obs["stats"]
    # 1. ingest: no loss within either segment, and a new sequence
    if stats["nmissing"]:
        out.append(f"ingest: {stats['nmissing']} packets missing")
    if stats["nseq"] < 2:
        out.append(f"ingest: {stats['nseq']} sequences, the break made "
                   f"none")
    rx = obs["rx"]
    # 2. fast dumps from both segments past the recovery margin
    gpa = cfg.acc_len // cfg.ntime_gulp
    want_a = n_a // gpa - 2
    want_b = (n_b - 10 * gpa) // gpa - 2
    if leg != "fx" and obs["ndump_fast"] < want_a + max(want_b, 1):
        out.append(f"fast dumps: {obs['ndump_fast']}, want "
                   f"{want_a} + {max(want_b, 1)}")
    for name in ("part", "corr"):
        if name in rx and leg != "fx":
            pkt = rx[name]["last_pkt"]
            decode = (pk.decode_corr_part if name == "part"
                      else pk.decode_corr_full)
            if not pkt or decode(pkt)[0].spectra_id < base:
                out.append(f"post-break: no {name} window after the break "
                           f"on the wire")
    # 3. every stream flowed and kept flowing near the end
    for name, r in rx.items():
        if not r["packets"]:
            out.append(f"flow: no {name} packets")
        elif obs["end_t"] - r["last_t"] >= obs["seconds"] / 2 + 10:
            out.append(f"flow: {name} stream died mid-run "
                       f"({obs['end_t'] - r['last_t']:.1f} s stale)")
    # slow dumps on both sides of the break
    pre = [s for s in obs["slow_seq0"] if s < n_a * cfg.ntime_gulp]
    post = [s for s in obs["slow_seq0"] if s >= base]
    if leg != "xb" and not (pre and post):
        out.append(f"slow dumps: {len(pre)} before the break, {len(post)} "
                   f"after")
    if leg == "fx":
        tones = obs["tone_chans"]
        ends = [tones[len(pre) - 1] if pre else None,
                tones[-1] if post else None]
        if any(t != TONE for t in ends):
            out.append(f"tone: channels {ends} at the last dump before and "
                       f"after the break, want {TONE}")
    if leg == "full":
        out += full_checks(obs, base)
    # 4. the mid-run trigger wrote a file that replays
    out += dump_checks(obs)
    # 5. the monitor bridge publishes
    if not obs["monitor_keys"]:
        out.append("monitor: the bridge published nothing")
    # 6. bounded memory
    out += memory_gate(obs["quarter"], obs["end"], obs["gulp_nbyte"])
    return out


def full_checks(obs: dict, base: int) -> list[str]:
    """The full leg's exact products: every fast window's subselection
    complete and equal to the truth, as many windows as fast dumps, on
    both sides of the break; every slow dump equal to the truth."""
    cfg = obs["cfg"]
    out = []
    part = obs["rx"]["part"]
    per_window = -(-cfg.nvis_out // 16)
    windows = part["windows"]
    short = {s: n for s, n in windows.items() if n != per_window}
    if short:
        out.append(f"subsel: {len(short)} windows not of {per_window} "
                   f"packets: {dict(list(short.items())[:4])}")
    if part["bad"]:
        out.append(f"subsel: packets differ from the truth in "
                   f"{len(part['bad'])} windows")
    if len(windows) != obs["ndump_fast"]:
        out.append(f"subsel: {len(windows)} windows received, "
                   f"{obs['ndump_fast']} fast dumps")
    n_pre = sum(1 for s in windows if s < obs["n_a"] * cfg.ntime_gulp)
    n_post = sum(1 for s in windows if s >= base)
    if not (n_pre and n_post):
        out.append(f"subsel: {n_pre} windows before the break, {n_post} "
                   f"after")
    if not all(obs["slow_exact"]) or not obs["slow_exact"]:
        bad = [s for s, ok in zip(obs["slow_seq0"], obs["slow_exact"])
               if not ok]
        out.append(f"slow dumps: {len(obs['slow_exact'])} grabbed, not "
                   f"equal to the truth at seq0 {bad[:4]}")
    return out


def dump_checks(obs: dict) -> list[str]:
    """The triggered dump: one file whose data is one gulp as ingested;
    at full width the very gulp sent at its ``seq0``."""
    if obs["trigger_error"]:
        return [f"dump: trigger failed: {obs['trigger_error']}"]
    dump = obs["dump"]
    if dump is None:
        return ["dump: the trigger produced no file"]
    cfg, data, hdr = obs["cfg"], dump["data"], dump["header"]
    out = []
    if data.nbytes != obs["gulp_nbyte"]:
        out.append(f"dump: {data.nbytes} B replayed, one gulp is "
                   f"{obs['gulp_nbyte']}")
    elif obs["leg"] == "full":
        k = _gulp_index(hdr["seq0"], cfg.ntime_gulp, obs["n_a"])
        frames = obs["frames"]
        if not np.array_equal(data.reshape(frames.shape[1:]),
                              frames[k % len(frames)]):
            out.append(f"dump: the file at seq0 {hdr['seq0']} differs "
                       f"from the gulp sent there")
    return out


def record(obs: dict, seconds: float, rate: float, duration: float,
           sampler: MemorySampler, reduced: list, device: str, sent,
           failures: list) -> dict:
    """The leg's JSON record: ``SOAK_r05.json``'s keys, then the port's."""
    cfg, stats, rx = obs["cfg"], obs["stats"], obs["rx"]
    quarter, end = obs["quarter"], obs["end"]
    n_a = obs["n_a"]
    base = (n_a + GAP_GULPS) * cfg.ntime_gulp
    rec = {"requested_duration_s": seconds,
           "actual_duration_s": round(duration, 1),
           "rate_gulps_per_s": rate, "ngulp": n_a + obs["n_b"],
           "segment_a_gulps": n_a, "segment_b_gulps": obs["n_b"],
           "nmissing": int(stats["nmissing"]), "nseq": int(stats["nseq"]),
           "ndump_fast": int(obs["ndump_fast"]),
           "ndump_slow": int(obs["ndump_slow"]),
           "ndumps_pre_break": sum(1 for s in obs["slow_seq0"]
                                   if s < n_a * cfg.ntime_gulp),
           "ndumps_post_break": sum(1 for s in obs["slow_seq0"]
                                    if s >= base),
           "wire_packets": {k: r["packets"] for k, r in rx.items()},
           "rss_warm_highwater_mb": (quarter or {}).get("rss_highwater_mb"),
           "rss_end_highwater_mb": end["rss_highwater_mb"],
           "rss_trajectory_s_mb": sampler.rss,
           "rss_growth_mb": (None if quarter is None else round(
               end["rss_highwater_mb"] - quarter["rss_highwater_mb"], 1))}
    card = (card_fields() if torch.device(device).type == "cuda"
            else {"device": None, "power_limit": None})
    rec.update({
        "leg": obs["leg"], "device": device, "card": card["device"],
        "power_limit": card["power_limit"],
        "commit": current_commit(), "reduced": reduced,
        "config": {k: getattr(cfg, k) for k in (
            "nstand", "nchan", "ntime_gulp", "acc_len", "acc_len_slow",
            "nbeam", "adc_dtype")},
        "quarter_mark_s": (quarter or {}).get("t_s"),
        "reserved_quarter_mb": (quarter or {}).get("reserved_mb"),
        "reserved_end_mb": end["reserved_mb"],
        "reserved_growth_mb": (None if end["reserved_mb"] is None
                               or quarter is None else round(
                                   end["reserved_mb"]
                                   - quarter["reserved_mb"], 1)),
        "reserved_limit_growth_mb": round(obs["gulp_nbyte"] / 1e6, 1),
        "device_trajectory_s_mb": sampler.device,
        "device_trajectory_fields": ["s", "memory_allocated",
                                     "memory_reserved",
                                     "pinned host pool"],
        "blaster": None if sent is None else {"packets": sent[0],
                                              "seconds": round(sent[1], 1)},
        "dump_file": None if obs["dump"] is None else obs["dump"]["file"]})
    if obs["leg"] == "full":
        part = rx["part"]
        rec.update({
            "subsel_windows": len(part["windows"]),
            "subsel_windows_exact": sum(
                1 for s, n in part["windows"].items()
                if n == -(-cfg.nvis_out // 16) and s not in part["bad"]),
            "slow_dumps_exact": sum(obs["slow_exact"]),
            "wire_bytes": {k: r["bytes"] for k, r in rx.items()}})
    rec["failures"] = failures
    rec["pass"] = not failures
    return rec


def write_record(path: str, leg: str, rec: dict) -> None:
    """Merge ``rec`` into the JSON file at ``path`` under ``<leg>_leg``,
    under a lock (legs may run at once)."""
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            doc = {}
        doc[f"{leg}_leg"] = rec
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Long-run soak of the X-engine driver (PyTorch + CUDA "
                    "port)")
    p.add_argument("--leg", choices=LEGS, default="xb")
    p.add_argument("--seconds", type=float, default=30.0,
                   help="requested duration; segment B runs at least past "
                        "the recovery margins")
    p.add_argument("--rate", type=float, default=None,
                   help="gulps a second offered (default: the leg's)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels; cpu their plain versions")
    p.add_argument("--record", type=str, default=None, metavar="PATH",
                   help="merge the leg's JSON record into this file")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available (use "
              "--device cpu for the plain reference path)", file=sys.stderr)
        return 2
    rec, _ = run_leg(args.leg, args.seconds, args.rate, args.device)
    print(json.dumps(rec), flush=True)
    if args.record:
        write_record(args.record, args.leg, rec)
    for f in rec["failures"]:
        print(f"FAILED: {f}", file=sys.stderr)
    return 0 if rec["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
