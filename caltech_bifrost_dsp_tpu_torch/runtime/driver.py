"""Pipeline assembly: source -> fused device step -> product sinks (port of
``caltech_bifrost_dsp_tpu/runtime/driver.py::XEnginePipeline``).

Three host threads around the step (the reference's 13 block threads,
lwa352-pipeline.py:57-311, collapsed as in the JAX driver):

- ingest: the source fills reservations of a backed staging ring in place
  (``fill_into``), or ``stream()`` gulps are copied in;
- compute: applies staged commands at accumulation boundaries, decides
  the boundary flags with two :class:`IntegrationController` s, runs a
  whole fast window per step call (per-gulp fallback for a partial
  window) and queues the products;
- output: fetches the products from the card and packetizes them (COR /
  partial visibilities / PBEAM / IBEAM), applying destination commands.

Upload to the card: a window is copied from the ring into one of two
pinned staging buffers, then H2D on a CUDA stream of its own; the step
waits on a CUDA event recorded after that copy, and the ring spans are
released only once the event has completed.  Products come back on a
third stream in the output thread, so the compute thread never waits on
the card.  On the CPU the step reads the ring memory directly and the
spans are released after it.

The command blocks keep the reference's control surface (typed keys,
staged application; corr_block.py:243-246, beamform_block.py:230-434,
corr_subsel_block.py:237-246, corr_output_full_block.py:412-415) and its
perf taxonomy.

With ``mesh=`` (a :class:`..parallel.mesh.Mesh`) the step runs as the
sharded programs of :mod:`..parallel.mesh`: the state is
``zero_sharded_state`` (fast accumulator as per-time-shard partials), the
step variant is chosen by the boundary flags and the wanted products, X/B
and FX (the ADC tail carried on the host goes in as ``carry_tail``), and
the products are unsharded before they reach the output thread.  The
upload stays one pinned buffer and one H2D to the mesh's first device;
shards on that device are views of the uploaded block, shards elsewhere
are copied device to device.

With ``history_nbyte`` the ingest thread also copies every gulp into a
:class:`..runtime.ring.HistoryRing` of that many bytes (raw ADC frames in
FX mode), the transient voltage recorder: a ``trigger`` command to the
``TriggeredDump`` block writes the ring to files from a thread of its own
(:class:`..io.sink.TriggeredDump`, O_DIRECT with ``dump_direct``), which
:class:`..io.source.TriggerFileSource` replays.

With ``stub_device_ms`` the step is a stub that measures the host half
alone (capture -> staging ring -> compute thread -> output thread;
``scripts/bench_pipeline.py --stub-device``): each call sleeps
``stub_device_ms * nspec / acc_len`` ms, for ``nspec`` spectra of packed
bytes (of ADC in FX mode), and gives a zero int32 subselection [nchan /
nchan_sum, nvis_out] on a dump, no power and no VLBI; a slow dump hands
zero planes to the COR sinks.  The stub uploads nothing, launches no kernel
and allocates no accumulator state, so it runs with ``device="cpu"`` on a
host without a card; the staged spans go back to the ring after the sleep,
never copied.  Its host memory is the staging ring (three fast windows:
0.97 GB at the LWA-352 width, 1.9 GB with int8 ADC, 7.8 GB with float32
ADC) and, from the first slow dump on, two [nchan, ninput, ninput] int32
planes of zero pages (2 x 381 MB mapped, touched only by a sink that reads
them).
"""

from __future__ import annotations

import json
import queue
import threading
import time

import numpy as np
import torch

from ..config import XEngineConfig
from ..control.command import CommandBlock
from ..io.sink import Throttle, TriggeredDump, UdpSender
from ..models import xengine
from ..ops import corr_subsel as cs
from ..ops.beamform import BeamGains
from ..ops.correlate import Vis
from ..ops.pfb import pfb_window
from ..parallel import mesh as pmesh
from ..utils.proclog import PerfTimer
from ..verification import golden
from .arming import Action, IntegrationController
from .ring import HistoryRing, Ring
from .runner import fx_scale


class CorrCommandBlock(CommandBlock):
    """Corr control endpoint wired to an IntegrationController
    (command keys per reference: corr_block.py:243-246)."""

    def __init__(self, name, ctrl: IntegrationController, granularity,
                 store=None, autostartat=0, acc_len=2400):
        super().__init__(name, store=store)
        self.ctrl = ctrl
        self.define_command_key(
            "start_time", type=int, initial_val=autostartat,
            condition=lambda x: (x == -1) or (x % granularity == 0))
        self.define_command_key(
            "acc_len", type=int, initial_val=acc_len,
            condition=lambda x: x % granularity == 0)
        self.update_stats({"xgpu_acc_len": granularity})

    def apply_pending(self):
        if self.update_pending:
            self.update_command_vals()
            self.ctrl.command(start_time=self.command_vals["start_time"],
                              acc_len=self.command_vals["acc_len"])


class BeamformCommandBlock(CommandBlock):
    """Beamform coefficient endpoint: staged gains with per-beam scheduled
    load samples (reference: beamform_block.py:230-242, 320-362,
    416-434).  Beams are silent (zero gains) until a load."""

    def __init__(self, cfg: XEngineConfig, store=None, device=None):
        super().__init__("Beamform", store=store, apply_immediately=True)
        self.cfg = cfg
        self.device = device
        self.cal_gains = np.ones(
            (cfg.nchan, cfg.nbeam, cfg.ninput), np.complex64)
        self.gains_new = np.zeros_like(self.cal_gains)
        self.gains_active = np.zeros_like(self.cal_gains)
        # -2 = no load pending; -1 = load now; >= 0 = load once the stream
        # reaches that sample (0 is a valid schedule: "from stream start")
        self.gains_load_sample = np.full(cfg.nbeam, -2, np.int64)
        self.freqs = (cfg.chan0 + np.arange(cfg.nchan)) * cfg.chan_bw_hz
        self.copy_pending = True
        self.define_command_key("coeffs", type=dict, initial_val={})
        self._on_command_applied = self._apply_coeffs
        for b in range(cfg.nbeam):
            self.update_stats({"cal_gains%d" % b: [False] * cfg.ninput})

    def _apply_coeffs(self, pending: dict):
        v = pending.get("coeffs") or {}
        try:
            if v.get("type") == "calgains":
                i, b = v["input_id"], v["beam_id"]
                data = np.array(v["data"])
                self.cal_gains[:, b, i] = data[0::2] + 1j * data[1::2]
                self.stats["cal_gains%d" % b][i] = True
            elif v.get("type") == "beamcoeffs":
                b = v["beam_id"]
                delays_ns = np.array(v["data"]["delays"])
                amps = np.array(v["data"]["amps"])
                phases = np.exp(1j * 2 * np.pi * self.freqs[:, None]
                                * delays_ns * 1e-9)
                self.gains_new[:, b, :] = (amps * phases
                                           * self.cal_gains[:, b, :])
                self.gains_load_sample[b] = v.get("load_sample", -1)
                self.update_pending = True
        except (KeyError, IndexError, ValueError, TypeError) as e:
            # a malformed command must not reach the store's watch thread
            self.update_stats({"last_cmd_error": str(e)})
            if self.log:
                self.log.error("BEAMFORM >> Failed to parse command: "
                               "%s", e)

    def stage_loads(self, this_gulp_time: int) -> bool:
        """Copy due per-beam coefficient sets into the active buffer
        (beamform_block.py:416-434).  Returns True if the device copy is
        (now) pending."""
        with self._control_lock:
            for b in range(self.cfg.nbeam):
                ls = self.gains_load_sample[b]
                if ls == -2:
                    continue
                if ls == -1 or this_gulp_time >= ls:
                    self.gains_active[:, b, :] = self.gains_new[:, b, :]
                    self.gains_load_sample[b] = -2
                    self.copy_pending = True
            if (self.gains_load_sample == -2).all():
                self.update_pending = False
        return self.copy_pending

    def device_gains(self) -> BeamGains:
        self.copy_pending = False
        return BeamGains.from_complex(self.gains_active, self.device)


class SubselCommandBlock(CommandBlock):
    """Baseline-selection endpoint (corr_subsel_block.py:237-246)."""

    def __init__(self, cfg: XEngineConfig, store=None, device=None):
        super().__init__("CorrSubsel", store=store)
        self.cfg = cfg
        self.device = device
        default = cs.default_baselines(cfg.nvis_out, cfg.nstand)
        self.define_command_key(
            "baselines", type=list, initial_val=default,
            condition=lambda x: len(x) == cfg.nvis_out)
        self._set(default)

    def _set(self, baselines):
        self.baselines = baselines
        self.pairs_device = torch.from_numpy(cs.baselines_to_inputs(
            baselines, self.cfg.npol).astype(np.int32)).to(self.device)
        # the selection list is exported via stats; the monitor bridge
        # caches it to a sub-key only on change
        self.update_stats({"baselines": self.baselines})

    def apply_pending(self) -> bool:
        """Returns True if the selection changed."""
        if not self.update_pending:
            return False
        self.update_command_vals()
        self._set(self.command_vals["baselines"])
        return True


class FEngineCommandBlock(CommandBlock):
    """Channelizer/requant endpoint (FX mode): runtime ``quant_scale`` and
    per-channel ``eq_gains``, staged at gulp boundaries."""

    def __init__(self, cfg: XEngineConfig, quant_scale: float = 1.0,
                 eq_gains=None, store=None, device=None):
        super().__init__("FEngine", store=store)
        self.cfg = cfg
        self.device = device
        self.define_command_key(
            "quant_scale", type=(int, float), initial_val=quant_scale,
            condition=lambda x: x > 0)
        self.define_command_key(
            "eq_gains", type=list,
            initial_val=list(eq_gains) if eq_gains is not None else [],
            condition=lambda v: len(v) in (0, cfg.nchan)
            and all(g > 0 for g in v))
        self._rebuild()

    def _rebuild(self):
        eq = self.command_vals["eq_gains"]
        scale = fx_scale(self.command_vals["quant_scale"], eq)
        self.scale_device = torch.from_numpy(scale).to(self.device)
        self.update_stats({"quant_scale": float(
                               np.float32(self.command_vals["quant_scale"])),
                           "eq_gains_set": bool(eq)})

    def apply_pending(self) -> bool:
        if not self.update_pending:
            return False
        self.update_command_vals()
        self._rebuild()
        return True


class OutputCommandBlock(CommandBlock):
    """Destination/throttle endpoint for a packet sink
    (corr_output_full_block.py:412-415).  ``dest_ip == "0.0.0.0"``
    disables emission; changes apply on the output thread at the next
    product."""

    def __init__(self, name: str, sink_obj, store=None,
                 dest_port: int = 10001):
        super().__init__(name, store=store)
        self.sink = sink_obj
        self.define_command_key("dest_ip", type=str, initial_val="0.0.0.0")
        self.define_command_key("dest_port", type=int,
                                initial_val=dest_port)
        self.define_command_key("dest_file", type=str, initial_val="")
        self.define_command_key("max_mbps", type=int, initial_val=-1)
        if hasattr(sink_obj, "autos_path"):
            # "" disables, else a directory for the sink's autos_<id>.npy
            self.define_command_key("write_autos", type=str,
                                    initial_val="")
        self._dest_fh = None

    def apply_pending(self):
        if not self.update_pending:
            return
        self.update_command_vals()
        try:
            self._apply_dest()
        except OSError as e:
            # a bad destination surfaces as a stat; it must not end the
            # output thread and wedge the pipeline behind a full queue
            self.update_stats({"last_apply_error": str(e)})
            self.sink.send = None

    def _apply_dest(self):
        if "write_autos" in self.command_vals and \
                hasattr(self.sink, "autos_path"):
            self.sink.autos_path = (self.command_vals["write_autos"]
                                    or None)
        ip = self.command_vals["dest_ip"]
        port = self.command_vals["dest_port"]
        dest_file = self.command_vals["dest_file"]
        if self._dest_fh is not None:
            self._dest_fh.close()
            self._dest_fh = None
        if dest_file:
            fh = open(dest_file, "ab", buffering=0)
            self._dest_fh = fh
            self.sink.send = fh.write
        elif ip and ip != "0.0.0.0":
            self.sink.send = UdpSender(ip, port)
        else:
            self.sink.send = None
        mbps = self.command_vals["max_mbps"]
        if hasattr(self.sink, "throttle"):
            # a sink-mandated cap (IBeamOutput.MAX_BPS) binds whatever the
            # operator asks; the sink's burst block size is kept
            cap = getattr(self.sink, "MAX_BPS", None)
            rate = mbps * 1e6 if mbps > 0 else None
            if cap is not None:
                rate = cap if rate is None else min(rate, cap)
            self.sink.throttle = Throttle(
                rate, block_bits=self.sink.throttle.block_bits)


class BeamOutputCommandBlock(CommandBlock):
    """Per-beam destination lists for the power-beam streams
    (beamform_output_block.py: dest_ip and dest_port are per-beam lists;
    '0.0.0.0' disables a beam)."""

    def __init__(self, sink_obj, nbeam2: int, store=None,
                 dest_port: int = 10000):
        super().__init__("BeamformOutput", store=store)
        self.sink = sink_obj
        self.nbeam2 = nbeam2
        self.define_command_key(
            "dest_ip", type=list, initial_val=["0.0.0.0"] * nbeam2,
            condition=lambda x: len(x) <= nbeam2)
        self.define_command_key(
            "dest_port", type=list, initial_val=[dest_port] * nbeam2,
            condition=lambda x: len(x) <= nbeam2)

    def apply_pending(self):
        if not self.update_pending:
            return
        self.update_command_vals()
        ips = self.command_vals["dest_ip"]
        ports = self.command_vals["dest_port"]
        senders = {}
        for b in range(min(len(ips), len(ports), self.nbeam2)):
            if ips[b] and ips[b] != "0.0.0.0":
                senders[b] = UdpSender(ips[b], int(ports[b]))
        self.sink.senders = senders


class TriggeredDumpCommandBlock(CommandBlock):
    """Trigger/abort/stop endpoint of the transient voltage recorder
    (command keys per reference: triggered_dump_block.py:164-169).  A
    trigger writes the files from a daemon thread; the block's ``state``
    stat is "dumping" meanwhile and "idle" after, with ``last_files`` and
    ``last_direct``."""

    def __init__(self, dumper, store=None):
        super().__init__("TriggeredDump", store=store,
                         apply_immediately=True)
        self.dumper = dumper
        self.define_command_key(
            "command", type=str, initial_val="",
            condition=lambda x: x in ("", "trigger", "abort", "stop"))
        self.define_command_key("ntime_per_file", type=int,
                                initial_val=1024)
        self.define_command_key("nfile", type=int, initial_val=1)
        self.define_command_key("dump_path", type=str, initial_val=".")
        self._on_command_applied = self._dispatch
        self.last_files: list = []

    def _dispatch(self, pending: dict):
        cmd = pending.get("command")
        if cmd == "trigger" and self.dumper is not None:
            def _run():
                self.update_stats({"state": "dumping"})
                try:
                    self.last_files = self.dumper.trigger(
                        self.command_vals["ntime_per_file"],
                        self.command_vals["nfile"],
                        self.command_vals["dump_path"])
                finally:
                    # a dump that dies mid-write must not leave "dumping";
                    # last_direct: whether O_DIRECT wrote the last file
                    self.update_stats({"state": "idle",
                                       "last_files": self.last_files,
                                       "last_direct":
                                       self.dumper.last_direct})

            threading.Thread(target=_run, daemon=True,
                             name="triggered-dump").start()
        elif cmd in ("abort", "stop") and self.dumper is not None:
            self.dumper.abort()


def source_fill_compatible(src_cls: type) -> bool:
    """Whether the ingest thread may have the source fill staging
    reservations in place (``fill_into``): only when the class defining
    the active ``stream()`` also defines ``fill_into``, so a subclass that
    overrides ``stream()`` alone keeps its generator semantics."""
    def owner(name):
        for c in src_cls.__mro__:
            if name in vars(c):
                return c
        return None

    fill = owner("fill_into")
    return fill is not None and fill is owner("stream")


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class XEnginePipeline:
    """One pipeline instance: threads + fused step + control endpoints.

    ``device`` is "cuda" (the kernels) or "cpu" (their plain versions);
    with ``mesh=`` it is the mesh's first device, and a ``device`` of
    another type than the mesh's raises.  After :meth:`run`, ``dump_times`` holds the host clock at which each
    fast dump's products left the output thread.

    ``history_nbyte`` > 0 keeps that many bytes of raw input in a
    :class:`HistoryRing` (``history``) behind a ``TriggeredDump`` command
    block (``dump_cmd``, writer ``dumper``; ``dump_direct`` for O_DIRECT).
    """

    def __init__(self, cfg: XEngineConfig, source, store=None,
                 corr_outputs=(), subsel_outputs=(), pbeam_outputs=(),
                 ibeam_outputs=(), history_nbyte: int = 0,
                 autostartat: int = 0, sync_time: int = 0,
                 selftest: bool = False, batch_accumulations: bool = True,
                 fx_mode: bool = False, quant_scale: float = 1.0,
                 eq_gains=None, mesh=None, dump_direct: bool = False,
                 stub_device_ms: float | None = None, device="cuda"):
        if fx_mode and selftest:
            raise ValueError("selftest compares packed post-F input; "
                             "not applicable in FX mode")
        if stub_device_ms is not None and selftest:
            raise ValueError("the stub device computes no visibilities for "
                             "the selftest to check")
        self.cfg = cfg
        self.stub_device_ms = stub_device_ms
        self._stub_slow = None
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.nproc > 1:
                raise ValueError("the driver runs a mesh of one process; "
                                 f"this one spans {mesh.nproc}")
            first = mesh.devices[0][0]
            if first.type != self.device.type:
                raise ValueError(f"device {device} but the mesh lies on "
                                 f"{first}")
            self.device = first
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda but no CUDA device is available")
        # the stub never touches the card: no streams, no pinned buffers
        self.cuda = self.device.type == "cuda" and stub_device_ms is None
        self.batch_accumulations = batch_accumulations
        # selftest: a (slow) numpy correlator alongside, every fast dump
        # compared exactly (the reference's Corr(test=True), corr_block.py:
        # 265-315)
        self.selftest = selftest
        self.selftest_failures = 0
        self.selftest_count = 0
        self._selftest_acc = None
        self.source = source
        self.sync_time = sync_time
        self.corr_outputs = list(corr_outputs)
        self.subsel_outputs = list(subsel_outputs)
        self.pbeam_outputs = list(pbeam_outputs)
        self.ibeam_outputs = list(ibeam_outputs)

        self.fast_ctrl = IntegrationController(
            cfg.ntime_gulp, cfg.acc_len, start_time=autostartat,
            recover_margin=10)
        self.slow_ctrl = IntegrationController(
            cfg.acc_len, cfg.acc_len_slow, start_time=autostartat,
            recover_margin=2, next_boundary_start=False)
        self.corr_cmd = CorrCommandBlock("Corr", self.fast_ctrl,
                                         cfg.ntime_gulp, store=store,
                                         autostartat=autostartat,
                                         acc_len=cfg.acc_len)
        self.corr_acc_cmd = CorrCommandBlock("CorrAcc", self.slow_ctrl,
                                             cfg.acc_len, store=store,
                                             autostartat=autostartat,
                                             acc_len=cfg.acc_len_slow)
        self.beam_cmd = BeamformCommandBlock(cfg, store=store,
                                             device=self.device)
        self.subsel_cmd = SubselCommandBlock(cfg, store=store,
                                             device=self.device)

        # Backed staging ring, an exact multiple of the fast window so a
        # window never straddles the wrap edge: one window held by the
        # compute thread, two of ingest headroom.  FX raw gulps hold
        # 2*nchan ADC samples per packed byte slot.
        self.fx_mode = fx_mode
        self._adc_dtype = cfg.adc_np_dtype
        raw_gulp = cfg.gulp_nbyte * (
            2 * self._adc_dtype.itemsize if fx_mode else 1)
        self._raw_gulp_nbyte = raw_gulp
        win_gulps = max(1, cfg.acc_len // cfg.ntime_gulp)
        nwin = max(3, -(-(1 << 22) // (win_gulps * raw_gulp)))
        self.staging = Ring("staging", nbyte_budget=nwin * win_gulps
                            * raw_gulp, backing=True)
        self.history = None
        self.dumper = None
        self.dump_cmd = None
        if history_nbyte:
            # a frame is one gulp as ingested: packed bytes, or raw ADC
            self.history = HistoryRing(history_nbyte, frame_nbyte=raw_gulp)
            self.dumper = TriggeredDump(self.history, direct=dump_direct)
            self.dump_cmd = TriggeredDumpCommandBlock(self.dumper,
                                                      store=store)
        self.output_cmds = []
        for name, sinks in (("CorrOutputFull", self.corr_outputs),
                            ("CorrOutputPart", self.subsel_outputs),
                            ("BeamformVlbiOutput", self.ibeam_outputs)):
            for s in sinks:
                self.output_cmds.append(OutputCommandBlock(name, s,
                                                           store=store))
        for s in self.pbeam_outputs:
            self.output_cmds.append(BeamOutputCommandBlock(
                s, cfg.nbeam // 2, store=store))
        self.out_queue: queue.Queue = queue.Queue(maxsize=8)
        # a product is computed and fetched only when a sink for it exists
        self._want_power = bool(self.pbeam_outputs)
        self._want_vlbi = bool(self.ibeam_outputs)
        self._want_subsel = bool(self.subsel_outputs)
        self.feng_cmd = None
        if fx_mode:
            # the (ntap-1) FIR history frames are carried between calls
            # on the host: zeros at start and after a sequence break
            self.feng_cmd = FEngineCommandBlock(cfg, quant_scale, eq_gains,
                                                store=store,
                                                device=self.device)
            self._window = torch.from_numpy(
                pfb_window(cfg.nchan, cfg.pfb_ntap)).to(self.device)
            self._adc_tail = np.zeros(
                ((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput),
                self._adc_dtype)
        # mesh: the fast accumulator is per-time-shard partials; the full
        # matrix exists only in a dump call's output, after the
        # once-per-window psum (kept for the selftest)
        self._mesh_steps: dict = {}
        self._last_mesh_vis = None
        if stub_device_ms is not None:
            self.state = None
        elif mesh is not None:
            self.state = xengine.XEngineState(
                *pmesh.zero_sharded_state(cfg, mesh))
        else:
            self.state = xengine.init_state(cfg, self.device)
        if self.cuda:
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)
            self._pinned = [None, None]       # two pinned staging buffers
            self._pinned_done = [None, None]  # event after each one's H2D
            self._npinned_used = 0
            self._held = []                   # (event, spans) to release
        self._stop = threading.Event()
        self._errors: list = []
        self.perf_compute = PerfTimer(self.corr_cmd.perf_proclog)
        self.ndump_fast = 0
        self.ndump_slow = 0
        self.dump_times: list = []

    # -- threads --------------------------------------------------------------

    def _ingest(self, ngulp: int):
        """Source -> staging ring.  A timestamp discontinuity starts a NEW
        sequence, as the reference's capture engine does; the compute
        thread then re-arms both integrators."""
        seq = None
        expected = None
        time_tag = 0
        for t, gulp, owned in self._gulp_iter(ngulp):
            if self._stop.is_set():
                break
            if seq is None or t != expected:
                if seq is not None:
                    self.staging.end_sequence(seq)
                time_tag += 1
                seq = self.staging.begin_sequence(
                    time_tag=time_tag,
                    header=self.source.header(seq0=t,
                                              sync_time=self.sync_time))
                if self.history is not None:
                    # frame `count` maps to t; sequences advance ntime_gulp
                    # a gulp in both modes (ADC sequences count output
                    # spectra), so that is the per-frame step
                    self.history.set_header(
                        seq.header,
                        t - self.history.count * self.cfg.ntime_gulp)
            if owned:
                self.staging.commit_span(seq, gulp)
            else:
                self.staging.write_span(seq, gulp)
            if self.history is not None:
                # a committed reservation is reused only after this
                # thread's next reserve_span, so the gulp is still whole
                self.history.push(gulp)
            expected = t + self.cfg.ntime_gulp
        if seq is not None:
            self.staging.end_sequence(seq)
        self.staging.shutdown()

    def _gulp_iter(self, ngulp: int):
        """Yield (t, gulp, ring_owned): the source fills reservations in
        place when it can (``fill_into``), else ``stream()`` gulps are
        copied into the ring."""
        cfg = self.cfg
        if not source_fill_compatible(type(self.source)):
            for t, gulp in self.source.stream(ngulp):
                yield t, gulp, False
            return
        n = 0
        while ngulp == 0 or n < ngulp:
            if self._stop.is_set():
                return
            dest = self.staging.reserve_span(self._raw_gulp_nbyte,
                                             timeout=2.0)
            if dest is None:
                continue  # backpressure or shutdown; _stop re-checked
            t = self.source.fill_into(dest)
            if t is None:  # capture poll timeout, or the source stopped
                self.staging.release_span(dest)
                if getattr(self.source, "_stopped", False):
                    return
                continue
            if self.fx_mode:
                gulp = dest.view(self._adc_dtype).reshape(-1, cfg.ninput)
            else:
                gulp = dest.reshape(cfg.ntime_gulp, cfg.nchan, cfg.ninput)
            yield t, gulp, True
            n += 1

    def _window_bytes(self, spans) -> tuple[np.ndarray, bool]:
        """Flat uint8 bytes of ``spans``: one ring view when they are
        byte-adjacent (the usual case), else a private copy.  Returns
        (bytes, still_in_ring)."""
        flat = self.staging.contiguous_view(spans)
        if flat is not None:
            return flat, True
        flat = np.concatenate([s.reshape(-1).view(np.uint8) for s in spans])
        self._release_spans(spans)
        return flat, False

    def _next_tail(self, adc: np.ndarray) -> np.ndarray:
        """The last (ntap-1) frames of this block, the next block's FIR
        history; empty for ntap == 1."""
        k = self._adc_tail.shape[0]
        return adc[len(adc) - k:].copy() if k else self._adc_tail

    def _upload(self, spans) -> tuple[torch.Tensor, np.ndarray]:
        """The step's input over ``spans`` on the device: packed [k *
        ntime_gulp, nchan, ninput] uint8, or in FX mode the ADC behind its
        FIR history.  Returns (block, host copy of the window's bytes)."""
        cfg = self.cfg
        flat, in_ring = self._window_bytes(spans)
        tail = None
        if self.fx_mode:
            adc = flat.view(self._adc_dtype).reshape(-1, cfg.ninput)
            tail = self._adc_tail
            self._adc_tail = self._next_tail(adc)
        if not self.cuda:
            if self.fx_mode:
                block = torch.from_numpy(np.concatenate([tail, adc]))
                self._release_spans(spans)
            else:
                block = torch.from_numpy(flat).reshape(-1, cfg.nchan,
                                                       cfg.ninput)
                if in_ring:
                    # the plain step runs synchronously on the ring memory
                    self._cpu_held = spans
            return block, flat
        k = self._npinned_used % 2
        self._npinned_used += 1
        done = self._pinned_done[k]
        if done is not None:
            done.synchronize()
        head = tail.nbytes if self.fx_mode else 0
        need = head + flat.nbytes
        if self._pinned[k] is None or self._pinned[k].numel() < need:
            self._pinned[k] = torch.empty(need, dtype=torch.uint8,
                                          pin_memory=True)
        host = self._pinned[k][:need]
        if head:
            host[:head].copy_(torch.from_numpy(tail.reshape(-1).view(
                np.uint8)))
        host[head:].copy_(torch.from_numpy(flat))
        if in_ring:
            # the host copy above is all the step needs of the ring, but
            # the spans are handed back only after the H2D has completed
            held = spans
        else:
            held = []
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._h2d_stream):
            block = host.to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._h2d_stream)
        block.record_stream(compute)
        compute.wait_event(ev)
        self._pinned_done[k] = ev
        self._held.append((ev, held))
        if self.fx_mode:
            block = block.view(_torch_dtype(self._adc_dtype)).reshape(
                -1, cfg.ninput)
        else:
            block = block.reshape(-1, cfg.nchan, cfg.ninput)
        return block, host.numpy()[head:]

    def _reap(self, wait: bool = False) -> None:
        """Release the ring spans of every upload whose H2D has completed
        (all of them with ``wait``)."""
        if not self.cuda:
            return
        keep = []
        for ev, spans in self._held:
            if wait:
                ev.synchronize()
            if wait or ev.query():
                self._release_spans(spans)
            else:
                keep.append((ev, spans))
        self._held = keep

    def _release_spans(self, spans) -> None:
        for s in spans:
            self.staging.release_span(s)

    def _stub_step(self, spans, is_dump):
        """The stub device: a sleep in proportion to the spectra in
        ``spans``, then zero products."""
        cfg = self.cfg
        per_spectrum = cfg.nchan * cfg.ninput * (
            2 * self._adc_dtype.itemsize if self.fx_mode else 1)
        nspec = sum(s.nbytes for s in spans) // per_spectrum
        time.sleep(self.stub_device_ms * 1e-3 * nspec / cfg.acc_len)
        self._release_spans(spans)
        subsel = None
        if is_dump:
            shape = (cfg.nchan // cfg.nchan_sum, cfg.nvis_out)
            subsel = Vis(torch.zeros(shape, dtype=torch.int32),
                         torch.zeros(shape, dtype=torch.int32))
        return xengine.XEngineOutputs(subsel, None, None)

    def _step(self, spans, gains_dev, is_first, is_dump, slow_first):
        """Upload ``spans`` and run one step call over them; the selftest
        correlator follows on the host copy."""
        if self.stub_device_ms is not None:
            return self._stub_step(spans, is_dump)
        self._cpu_held = None
        block, host = self._upload(spans)
        cfg = self.cfg
        if self.mesh is not None:
            out = self._mesh_step(block, gains_dev, is_first, is_dump,
                                  slow_first)
        elif self.fx_mode:
            self.state, out = xengine.fx_step(
                self.state, block, self._window, self.feng_cmd.scale_device,
                gains_dev, self.subsel_cmd.pairs_device, is_first, is_dump,
                slow_first, cfg, self._want_power, self._want_vlbi,
                self._want_subsel)
        else:
            self.state, out = xengine.xengine_step(
                self.state, block, gains_dev, self.subsel_cmd.pairs_device,
                is_first, is_dump, slow_first, cfg, self._want_power,
                self._want_vlbi, self._want_subsel)
        if self.selftest:
            self._selftest_update(host, is_first, is_dump)
        if self._cpu_held:
            self._release_spans(self._cpu_held)
        return out

    def _mesh_step(self, block, gains_dev, is_first, is_dump, slow_first):
        """One sharded step call; the products come back unsharded on the
        mesh's first device."""
        cfg = self.cfg
        key = (bool(is_first), bool(is_dump), bool(slow_first))
        if key not in self._mesh_steps:
            build = (pmesh.fx_sharded_state_fn if self.fx_mode
                     else pmesh.xengine_sharded_state_fn)
            self._mesh_steps[key] = build(
                cfg, self.mesh, *key, want_power=self._want_power,
                want_vlbi=self._want_vlbi, want_subsel=self._want_subsel)
        step = self._mesh_steps[key]
        state = (self.state.vis_fast, self.state.vis_slow)
        pairs = self.subsel_cmd.pairs_device
        if self.fx_mode:
            # on-mesh halo between time shards; the host carries only the
            # block-boundary ADC tail, uploaded in front of the block
            k = self._adc_tail.shape[0]
            state, out, vlbi = step(state, block[k:], block[:k],
                                    self._window,
                                    self.feng_cmd.scale_device, gains_dev,
                                    pairs)
        else:
            state, out, vlbi = step(state, block, gains_dev, pairs)
        self.state = xengine.XEngineState(*state)
        if out.vis is not None:
            self._last_mesh_vis = out.vis
        dev = self.device
        return xengine.XEngineOutputs(
            None if out.subsel is None
            else Vis(*(pmesh.unshard(p, dev) for p in out.subsel)),
            None if out.bf_power is None
            else pmesh.unshard(out.bf_power, dev),
            None if vlbi is None else pmesh.unshard(vlbi, dev))

    def _dense(self, which: str) -> Vis:
        """The full Hermitian matrix of the fast ("fast", valid after a
        dump call) or slow ("slow") accumulator on the first device; zero
        planes of the host under the stub device."""
        if self.state is None:
            if self._stub_slow is None:
                # np.zeros maps zero pages: nothing is written
                shape = (self.cfg.nchan, self.cfg.ninput, self.cfg.ninput)
                self._stub_slow = Vis(
                    *(torch.from_numpy(np.zeros(shape, np.int32))
                      for _ in range(2)))
            return self._stub_slow
        if self.mesh is None:
            vis = (self.state.vis_fast if which == "fast"
                   else self.state.vis_slow)
            return xengine.dense_vis(vis, self.cfg)
        # mesh: both are dense already (mirrored after the psum)
        vis = self._last_mesh_vis if which == "fast" else self.state.vis_slow
        return Vis(*(pmesh.unshard(p, self.device) for p in vis))

    def _emit(self, out, t, dec, slow_dec):
        """Queue device-resident products for the output thread, which
        fetches them from the card off the compute thread's path."""
        products = {"seq0": t}
        if out.bf_power is not None:
            products["bf_power"] = out.bf_power
        if out.vlbi is not None:
            products["vlbi"] = out.vlbi
        if dec.action == Action.DUMP:
            if out.subsel is not None:
                products["subsel"] = out.subsel
                products["subsel_baselines"] = self.subsel_cmd.baselines
            products["fast_seq0"] = dec.seq0
            products["acc_len"] = dec.acc_len
            self.ndump_fast += 1
            if slow_dec.action == Action.DUMP:
                products["vis_slow_planes"] = self._dense("slow")
                products["slow_seq0"] = slow_dec.seq0
                products["slow_acc_len"] = slow_dec.acc_len
                self.ndump_slow += 1
        if self.cuda:
            products["ready"] = torch.cuda.Event()
            products["ready"].record(torch.cuda.current_stream(self.device))
        self.out_queue.put(products)

    def _sync_slow_granularity(self):
        """A runtime fast acc_len change alters the slow accumulator's
        input grid; realign it as the reference does for a new upstream
        sequence (corr_acc_block.py:215-235)."""
        new_g = self.fast_ctrl.acc_len
        slow = self.slow_ctrl
        if slow.acc_len % new_g:
            self.corr_acc_cmd.update_stats(
                {"upstream_acc_error":
                 f"acc_len {slow.acc_len} incompatible with upstream "
                 f"{new_g}"})
        slow.granularity = new_g
        base = self.fast_ctrl.start_time
        if slow.started:
            slow.on_sequence_start(base)
            return
        # not started: the armed start must land on the NEW fast dump grid
        # and not before the fast restart, else its boundary never comes
        st, al = (slow._pending if slow.update_pending
                  else (slow.start_time, slow.acc_len))
        if st is None or st == -1 or not al:
            return
        st2 = st
        if st2 < base:
            st2 = st + -(-(base - st) // al) * al  # ceil to its grid
        off = (st2 - base) % new_g
        if off:
            st2 += new_g - off
        if st2 != st:
            slow._pending = (st2, al)
            slow.update_pending = True

    def _selftest_update(self, window: np.ndarray, is_first, is_dump):
        cfg = self.cfg
        ref = golden.reference_correlation(window.reshape(
            -1, cfg.nchan, cfg.nstand, cfg.npol))
        self._selftest_acc = (ref if is_first
                              else self._selftest_acc + ref)
        if is_dump:
            fast = self._dense("fast")
            got = (fast.real.cpu().numpy().astype(np.complex128)
                   + 1j * fast.imag.cpu().numpy())
            ok = golden.check_vis_against_golden(got, self._selftest_acc)
            self.selftest_count += 1
            if not ok:
                self.selftest_failures += 1
            self.corr_cmd.update_stats({"selftest_ok": bool(ok)})

    def _compute(self):
        # the sentinel reaches the output thread on every exit path
        try:
            self._compute_loop()
        finally:
            self._reap(wait=True)
            self.out_queue.put(None)

    def _compute_loop(self):
        cfg = self.cfg
        gains_dev = self.beam_cmd.device_gains()
        gulps_per_acc = self.fast_ctrl.acc_len // cfg.ntime_gulp
        for seq in self.staging.read():
            hdr = seq.header
            t = hdr["seq0"]
            self.corr_cmd.sequence_proclog.update(hdr)
            self.corr_acc_cmd.sequence_proclog.update(hdr)
            if self.fx_mode:
                # a new sequence is a stream break: the FIR must not
                # convolve across the gap
                self._adc_tail = np.zeros_like(self._adc_tail)
            self.fast_ctrl.on_sequence_start(t)
            # the slow accumulator consumes the FAST output stream, so it
            # realigns from the fast controller's recovered start
            # (corr_acc_block.py:215-235)
            self.slow_ctrl.on_sequence_start(
                max(t, self.fast_ctrl.start_time))
            slow_dec = None
            batch: list = []  # buffered (t, span, dec) within one window
            for span in self.staging.read_spans(seq):
                self.perf_compute.mark_acquire()
                self._reap()
                if self._stop.is_set():
                    return
                if not batch:
                    # commands and coefficient loads apply at window
                    # boundaries (gulp boundaries in unbatched mode)
                    self.corr_cmd.apply_pending()
                    self.corr_acc_cmd.apply_pending()
                    self.subsel_cmd.apply_pending()
                    if self.feng_cmd is not None:
                        self.feng_cmd.apply_pending()
                    if self.beam_cmd.stage_loads(t):
                        gains_dev = self.beam_cmd.device_gains()
                    gulps_per_acc = max(
                        1, self.fast_ctrl.acc_len // cfg.ntime_gulp)
                dec = self.fast_ctrl.on_gulp(t)
                if self.fast_ctrl.acc_len and \
                        self.fast_ctrl.acc_len != self.slow_ctrl.granularity:
                    self._sync_slow_granularity()
                self.corr_cmd.update_stats(
                    {"state": self.fast_ctrl.state, "curr_sample": t})
                if dec.action == Action.SKIP:
                    self.staging.release_span(span)
                    t += cfg.ntime_gulp
                    self.perf_compute.tick()
                    continue
                if dec.is_first:
                    slow_dec = self.slow_ctrl.on_gulp(dec.seq0)
                    self.corr_acc_cmd.update_stats(
                        {"state": self.slow_ctrl.state})
                self.perf_compute.mark_reserve()
                # a runtime acc_len larger than the ring can hold must not
                # buffer a whole window (writer deadlock)
                fits = (gulps_per_acc + 2) * self._raw_gulp_nbyte \
                    <= self.staging.nbyte_budget
                if self.batch_accumulations and gulps_per_acc > 1 \
                        and fits:
                    batch.append((t, span, dec))
                    if dec.action == Action.DUMP:
                        if len(batch) == gulps_per_acc:
                            # the whole window in ONE step call
                            out = self._step([s for _, s, _ in batch],
                                             gains_dev, True, True,
                                             slow_dec.is_first)
                            self._emit(out, batch[0][0], dec, slow_dec)
                        else:
                            # partial window (armed or recovered mid-way):
                            # per-gulp fallback
                            for tg, sg, dg in batch:
                                out = self._step(
                                    [sg], gains_dev, dg.is_first,
                                    dg.action == Action.DUMP,
                                    slow_dec.is_first)
                                self._emit(out, tg, dg, slow_dec)
                        batch = []
                        self.perf_compute.mark_process(
                            gulps_per_acc * span.nbytes)
                        self.perf_compute.publish()
                        self.corr_cmd.update_stats({"last_end_sample": t})
                else:
                    out = self._step([span], gains_dev, dec.is_first,
                                     dec.action == Action.DUMP,
                                     slow_dec.is_first)
                    self._emit(out, t, dec, slow_dec)
                    self.perf_compute.mark_process(span.nbytes)
                    self.perf_compute.publish()
                    if dec.action == Action.DUMP:
                        self.corr_cmd.update_stats({"last_end_sample": t})
                t += cfg.ntime_gulp
            # sequence ended mid-window: hand leftover ring memory back
            self._release_spans([s for _, s, _ in batch])

    def _fetch(self, item: dict) -> None:
        """Device products -> numpy, on a stream of their own that waits
        only for the step that made them."""
        keys = [k for k in ("bf_power", "vlbi") if k in item]
        pairs = [k for k in ("subsel", "vis_slow_planes") if k in item]
        ready = item.pop("ready", None)

        def fetch():
            for k in keys:
                item[k] = item[k].cpu().numpy()
            for k in pairs:
                item[k] = tuple(p.cpu().numpy() for p in item[k])

        if ready is None:
            fetch()
            return
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(ready)
            fetch()

    def _output(self):
        cfg = self.cfg
        while True:
            item = self.out_queue.get()
            if item is None:
                return
            self._fetch(item)
            for oc in self.output_cmds:
                oc.apply_pending()
            if "bf_power" in item:
                for snk in self.pbeam_outputs:
                    snk.send_powers(item["bf_power"], item["seq0"],
                                    cfg.ntime_sum)
            if "vlbi" in item:
                for snk in self.ibeam_outputs:
                    snk.send_voltages(item["vlbi"], item["seq0"])
            if "subsel" in item:
                for snk in self.subsel_outputs:
                    snk.send_subsel(item["subsel"][0], item["subsel"][1],
                                    np.asarray(item["subsel_baselines"],
                                               np.uint32),
                                    self.sync_time, item["fast_seq0"],
                                    item["acc_len"])
            if "vis_slow_planes" in item:
                vr, vi = item["vis_slow_planes"]
                for snk in self.corr_outputs:
                    if snk.checkfile:
                        snk.check_against_file(
                            vr, vi, item["slow_acc_len"],
                            item["slow_seq0"] // item["slow_acc_len"])
                    snk.send_matrix_planes(vr, vi, self.sync_time,
                                           item["slow_seq0"],
                                           item["slow_acc_len"])
            if "fast_seq0" in item:
                self.dump_times.append(time.perf_counter())

    # -- lifecycle ------------------------------------------------------------

    def _guard(self, stage):
        """Run a stage; an exception stops the pipeline and is re-raised
        by :meth:`run`.  A failed output stage keeps draining the queue so
        the compute thread can finish."""
        try:
            stage()
        except Exception as e:  # noqa: BLE001 - re-raised by run()
            self._errors.append(e)
            self.shutdown()
            if stage == self._output:
                while self.out_queue.get() is not None:
                    pass

    def run(self, ngulp: int, timeout_s: float | None = None):
        """Run all three stages to completion for ``ngulp`` gulps."""
        threads = [
            threading.Thread(target=self._guard,
                             args=(lambda: self._ingest(ngulp),),
                             name="ingest", daemon=True),
            threading.Thread(target=self._guard, args=(self._compute,),
                             name="compute", daemon=True),
            threading.Thread(target=self._guard, args=(self._output,),
                             name="output", daemon=True),
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout_s)
            if th.is_alive():
                self.shutdown()
                raise TimeoutError(f"pipeline stage {th.name} stalled")
        if self._errors:
            raise RuntimeError("pipeline stage failed") from self._errors[0]

    def shutdown(self):
        """Stop every stage: the flag, the source (a capture blocked in a
        poll or holding a socket), then the staging ring."""
        self._stop.set()
        if hasattr(self.source, "stop"):
            self.source.stop()
        self.staging.shutdown()


def build_pipeline_from_json(cfg_json: str, **kw) -> XEnginePipeline:
    """A pipeline from a JSON blob ``{"config": {...XEngineConfig fields},
    "source": {...SyntheticSource arguments}}``; ``kw`` goes to
    :class:`XEnginePipeline`."""
    from ..io.source import SyntheticSource

    d = json.loads(cfg_json)
    cfg = XEngineConfig(**d.get("config", {}))
    src = SyntheticSource(cfg, **d.get("source", {}))
    return XEnginePipeline(cfg, src, **kw)
