"""One run of one cell: set-up, the measured window, the optional trace,
and the comparison, for one pipeline (:class:`CellRun`); a configuration
of two pipelines on one card runs two such in processes of their own
(:mod:`xbench.pair`).

Set-up (``setup_s``): the port's import and kernel library, the pool made
from ``--seed``, a warm-up pipeline of the cell's own shapes and sinks
(its slow accumulation cut to ``warmup_windows`` so that the slow dump's
planes, fetch and allocations are warmed too, and held until the
products queue is full, so that set-up reaches the device's peak), and the measured
pipeline, which takes over the warm-up's pinned staging buffers.  The window: the
measured pipeline runs in a closed loop for ``seconds``; then the
harness calls ``shutdown()``, the output thread drains, and the state is
read.  ``realtime_factor`` is the sky time of the fast dumps that
completed inside the window over the wall time between the first and the
last of them (``XEnginePipeline.dump_times``).
"""

from __future__ import annotations

import gc
import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .reference import check as ref_check
from .sinks import SinkProxy, spanned
from .trace import Trace
from .traffic.pool import PoolSource, make_pool

#: spectra per second of the F-engine (fs / 2 / 4096 channels)
SPECTRA_RATE_HZ = 196e6 / (2 * 4096)


@dataclass
class Readings:
    """What the per-layer metrics read."""
    p: dict
    fx: bool
    seconds: float
    t0_ns: int
    t1_ns: int
    compute_process_s: float | None = None
    rtf: float | None = None
    spans: list = field(default_factory=list)
    trace: Trace | None = None


def sizes(conf: dict, cfg) -> dict:
    """The sizes the reference and the metrics read, as plain numbers."""
    p = dict(conf["xengine"])
    for k in ("nstand", "npol", "nchan", "ntime_gulp", "acc_len",
              "acc_len_slow", "nbeam", "ntime_sum", "nchan_sum",
              "pipeline_id", "pfb_ntap", "adc_dtype"):
        p[k] = getattr(cfg, k)
    p["quant_scale"] = conf.get("quant_scale", 1.0)
    return p


def keep_set(traffic: dict, seed: int, horizon: int = 1 << 16) -> set:
    """Fast windows whose packets the check keeps: the first few, then a
    seeded share, at most ``max_windows``."""
    k = traffic.get("keep")
    if not k:
        return set()
    u = np.random.default_rng([seed, 1]).random(horizon)
    keep = list(range(k["first_windows"]))
    keep += [w for w in range(k["first_windows"], horizon)
             if u[w] < k["share"]]
    return set(keep[:k["max_windows"]])


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             override: dict | None = None, t_start: float | None = None,
             log=print) -> dict:
    """Run cell ``c`` (:func:`xbench.spec.cell`) once, its one pipeline in
    this process, and return the result line's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with a trace
    ``breakdown``, then ``checks``); info lines go to ``log``.
    ``override`` replaces configuration sizes (CPU tests); ``control``
    runs the comparison's control."""
    run = CellRun(c, seed, seconds, trace, device, control, override,
                  t_start, log)
    run.setup()
    run.window()
    checks, attempted, failed = run.compare()
    r = run.readings
    if trace:
        metrics = per_layer(c, r)
    else:
        metrics = end_to_end(c, r.rtf, run.peak, run.setup_s)
    return result_line(checks, attempted, failed, metrics,
                       run.device_info(run.peak), r.trace, r.spans)


def end_to_end(c: dict, rtf: float, peak: int, setup_s: float) -> dict:
    """The cell's end-to-end metrics, as its file lists them."""
    e2e = {
        "realtime_factor": {"value": rtf, "unit": "x"},
        "device_peak_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
        "setup_s": {"value": setup_s, "unit": "s"}}
    return {k: e2e[k] for k in c["workload"]["end_to_end"]}


def per_layer(c: dict, r: Readings | None, read=None) -> dict:
    """The cell's per-layer metrics that find something to read in
    ``r``, or that ``read(module, name)`` finds where it is given (a
    pair's, :func:`xbench.pair.combine`)."""
    out = {}
    for m in c["metrics"]:
        name = m.__name__.rsplit(".", 1)[1]
        v = m.read(r) if read is None else read(m, name)
        if v is not None:
            out[name] = {"value": float(v), "unit": m.UNIT}
    return out


def result_line(checks: list, attempted: int, failed: int, metrics: dict,
                devinfo: dict, trace: Trace | None = None,
                spans: list = ()) -> dict:
    """The result line's fields; a trace adds the device's busy and
    window seconds and the ``breakdown``, its idle gaps named by
    ``spans``."""
    out = {"correct": all(ch.ok for ch in checks),
           "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": devinfo}
    if trace is not None:
        devinfo["busy_s"] = trace.busy_s
        devinfo["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(),
                            "idle_gaps": trace.idle_gaps(spans)}
    out["checks"] = {ch.name: {"value": ch.value, "limit": ch.limit}
                     for ch in checks}
    return out


class CellRun:
    """One pipeline of a cell, in three phases: :meth:`setup`,
    :meth:`window` and :meth:`compare` (:func:`run_cell` runs them in
    turn; :mod:`xbench.pair` runs each pipeline of a pair so, in a
    process of its own)."""

    def __init__(self, c: dict, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", control: bool = False,
                 override: dict | None = None,
                 t_start: float | None = None, log=print):
        self.c, self.seed, self.seconds, self.trace = c, seed, seconds, trace
        self.device, self.control, self.override = device, control, override
        self.t_start = time.perf_counter() if t_start is None else t_start
        self.log = log

    def setup(self) -> None:
        """The port's kernel library, the pool, the warm-up pipeline and
        the measured one, ready to run."""
        import torch

        from caltech_bifrost_dsp_tpu_torch import config as pconfig
        from caltech_bifrost_dsp_tpu_torch.runtime.driver import (
            XEnginePipeline)

        c, seed, device = self.c, self.seed, self.device
        conf, traf, kinds = c["config"], c["traffic"], c["sinks"]
        fx = bool(conf["fx"])
        xe = dict(conf["xengine"])
        xe.update(self.override or {})
        if conf.get("engines") == "TPU_ENGINES":
            xe.update(pconfig.TPU_ENGINES)
        if self.control:
            # the program's own lower-precision path, where that is the
            # control
            xe.update(conf["control"].get("program", {}))
        cfg = pconfig.XEngineConfig(**xe)
        p = sizes(conf, cfg)
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
            _build.library()
        gpw = cfg.acc_len // cfg.ntime_gulp
        shape = ((cfg.ntime_gulp * 2 * cfg.nchan, cfg.ninput) if fx
                 else (cfg.ntime_gulp, cfg.nchan, cfg.ninput))
        npool = traf["pool_gulps"]
        raw = int(np.prod(shape)) * (cfg.adc_np_dtype.itemsize if fx else 1)
        pool: list = []

        commanded: dict = {}
        commands: list = []
        for mod in kinds.values():
            commands += mod.commands(cfg, conf, traf, seed, commanded)

        def pipeline(cfgx, src):
            outputs: dict = {}
            sends: dict = {}
            for name, mod in kinds.items():
                snk, sends[name] = mod.build(cfgx, conf)
                outputs[mod.ATTR] = [snk]
            pipe = XEnginePipeline(cfgx, src, fx_mode=fx,
                                   quant_scale=conf.get("quant_scale", 1.0),
                                   device=device, **outputs)
            for block, kw in commands:
                getattr(pipe, block).process_command_strings(json_cmd(kw))
            slots = pipe.staging.nbyte_budget / raw
            if slots != npool:
                # the source writes each ring slot once only when the ring
                # hands its slots back in the pool's order
                raise RuntimeError(
                    f"the staging ring holds {slots:g} gulps, the traffic's "
                    f"pool {npool}: the source would write every gulp")
            return pipe, sends

        # warm-up: the cell's shapes, its slow dump after ``warmup_windows``
        # windows; the output thread holds the slow dump's planes until the
        # products queue is full, so the device's peak (state, slow planes,
        # a window's working set, a full queue) is reached here, whatever
        # the threads' timing does in the window
        nw = traf["warmup_windows"]
        wcfg = cfg.replace(acc_len_slow=nw * cfg.acc_len)
        wsrc = PoolSource(wcfg, pool, adc=fx)
        warm, wsends = pipeline(wcfg, wsrc)
        pool += make_pool(npool, shape, conf["input"]["kind"], seed, dev,
                          conf["input"].get("amplitude", 0.0))
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        warm.out_queue.get = _holding_slow(warm.out_queue)
        # one slow dump (after window nw - 1), then a full queue behind it
        # and no second dump
        depth = min(warm.out_queue.maxsize, nw - 2)
        warm.run((nw + depth + 1) * gpw, timeout_s=900)
        wsrc.check_written_once()
        # the measured pipeline takes over the warm-up's pinned staging
        # buffers, so that none is allocated in the window
        pinned = warm._pinned if cuda else None
        for s in wsends.values():
            for x in s:
                x.close()
        del warm
        gc.collect()

        if self.trace:
            # the profiler's first start initializes CUPTI; do it in set-up
            with _profiler(cuda):
                torch.ones(8, device=dev).sum().item()
        spans: list = []
        src = PoolSource(cfg, pool, adc=fx)
        src.fill_into = spanned("ingest.fill", src.fill_into, spans)
        pipe, sends = pipeline(cfg, src)
        if cuda:
            pipe._pinned = pinned
        pipe._step = spanned("compute.step", pipe._step, spans)
        # the compute thread's wait for room in the products queue
        pipe.out_queue.put = spanned("compute.put", pipe.out_queue.put,
                                     spans)
        keep = keep_set(traf, seed)
        for name, mod in kinds.items():
            snk, = getattr(pipe, mod.ATTR)
            setattr(snk, mod.METHOD, SinkProxy(
                f"output.{mod.METHOD}", getattr(snk, mod.METHOD),
                mod.SEQ_ARG, cfg.acc_len, sends[name], keep.__contains__,
                spans))
        self.torch, self.cfg, self.p, self.fx = torch, cfg, p, fx
        self.dev, self.cuda, self.pool = dev, cuda, pool
        self.commanded, self.keep, self.spans = commanded, keep, spans
        self.src, self.pipe, self.sends = src, pipe, sends

    def window(self, start_unix: float | None = None) -> None:
        """The measured window: the pipeline in a closed loop for
        ``seconds`` from now, or from Unix time ``start_unix``, then
        drained; the rate, the peak and the readings (with the profiled
        slice of a traced run) kept."""
        torch, cfg, fx, log = self.torch, self.cfg, self.fx, self.log
        pipe, src, spans, seconds = self.pipe, self.src, self.spans, \
            self.seconds
        errors: list = []

        def serve():
            try:
                pipe.run(0)
            except Exception as e:  # noqa: BLE001 - reported after the window
                errors.append(e)

        prof = None
        tr = {}
        runner = threading.Thread(target=serve, name="xbench-serve")
        if start_unix is not None:
            _sleep_until(time.perf_counter() + start_unix - time.time())
        t0 = time.perf_counter()
        t0_ns = time.time_ns()
        self.setup_s = t0 - self.t_start
        runner.start()
        process0 = pipe.perf_compute.process_time
        if self.trace:
            _sleep_until(t0 + 0.2 * seconds)
            prof = _profiler(self.cuda)
            tr["n0"] = pipe.ndump_fast
            tr["t0_ns"] = time.time_ns()
            prof.start()
            tr["start_s"] = (time.time_ns() - tr["t0_ns"]) / 1e9
        _sleep_until(t0 + seconds)
        t_end = time.perf_counter()
        t1_ns = time.time_ns()
        process_s = pipe.perf_compute.process_time - process0
        if prof is not None:
            tr["t1_ns"] = time.time_ns()
            tr["n1"] = pipe.ndump_fast
            prof.stop()
            log(f"xbench: profiler started in {tr['start_s']:.3f} s, "
                f"stopped in {(time.time_ns() - tr['t1_ns']) / 1e9:.3f} s")
        pipe.shutdown()
        runner.join(timeout=300)
        if runner.is_alive():
            raise TimeoutError("the pipeline did not drain within 300 s")
        if errors:
            raise RuntimeError("the pipeline failed") from errors[0]
        src.check_written_once()

        self.peak = torch.cuda.max_memory_allocated(self.dev) \
            if self.cuda else 0
        done = [d for d in pipe.dump_times if t0 <= d <= t_end]
        if len(done) < 2:
            raise RuntimeError(f"{len(done)} fast dumps completed in the "
                               f"{seconds}-s window; the rate needs two")
        window_sky_s = cfg.acc_len / SPECTRA_RATE_HZ
        rtf = (len(done) - 1) * window_sky_s / (done[-1] - done[0])
        raw_gbps = cfg.input_gbps * (2 * cfg.adc_np_dtype.itemsize if fx
                                     else 1)
        gaps = np.diff(done)
        for label in ("ingest.fill", "compute.step", "compute.put"):
            d = [(b - a) / 1e9 for lb, a, b, _ in spans
                 if lb == label and t0_ns <= a < t1_ns]
            if d:
                log(f"xbench: {label} median {np.median(d):.4f} s, "
                    f"{sum(d) / (t_end - t0):.3f} of the window, "
                    f"{len(d)} calls")
        per_slow = cfg.acc_len_slow // cfg.acc_len
        log(f"xbench: dump intervals median {np.median(gaps):.4f} s, longest "
            f"{np.sort(gaps)[-3:].round(4).tolist()} s; "
            f"{pipe.ndump_fast // per_slow} slow dumps in "
            f"{pipe.ndump_fast} windows")
        log(f"xbench: the source wrote {src.nwritten} of {src.nfilled} gulps "
            f"(a pool of {len(self.pool)})")
        log(f"xbench: {len(done)} fast dumps in the window, "
            f"{rtf * raw_gbps:.4f} Gb/s of {'ADC' if fx else 'packed'} "
            f"input, {pipe.ndump_fast} windows stepped; realtime_factor "
            f"{rtf!r}")

        self.readings = Readings(self.p, fx, t_end - t0, t0_ns, t1_ns,
                                 compute_process_s=process_s, rtf=rtf,
                                 spans=spans)
        if prof is not None:
            self.readings.trace = Trace.from_profiler(
                prof, tr["t0_ns"], tr["t1_ns"], tr["n1"] - tr["n0"])
            del prof

    def compare(self) -> tuple[list, int, int]:
        """The program's products taken and its state freed, then the
        comparison (:func:`xbench.reference.check.compare`): (checks,
        answers compared, answers wrong)."""
        pipe, sends, torch = self.pipe, self.sends, self.torch
        nwin = pipe.ndump_fast
        planes = [tuple(x.cpu().numpy() for x in v) for v in pipe.state]
        pipe.state = None
        kept = {name: [pkt for x in s for pkt in x.kept]
                for name, s in sends.items()}
        for s in sends.values():
            for x in s:
                x.close()
        windows = {s[3] for s in self.spans
                   if s[0].startswith("output.") and s[3] in self.keep}
        del pipe
        self.pipe = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        c = self.c
        return ref_check.compare(
            self.p, c["config"], c["sinks"], self.pool, nwin, planes[0],
            planes[1], kept, windows, self.commanded,
            c["workload"]["limits"], self.dev, control=self.control)

    def device_info(self, peak: int) -> dict:
        """The result line's ``device``, with ``peak`` bytes."""
        cuda, dev = self.cuda, self.dev
        return {"platform": "gpu" if cuda else "cpu",
                "kind": (self.torch.cuda.get_device_name(dev) if cuda
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}


def _holding_slow(q):
    """``q.get`` that, on the first item carrying slow-dump planes, waits
    (10 s at most) until the queue is full before handing it on."""
    get = q.get
    held = []

    def get_held(*a, **kw):
        item = get(*a, **kw)
        if not held and item is not None and "vis_slow_planes" in item:
            held.append(True)
            end = time.perf_counter() + 10.0
            while not q.full() and time.perf_counter() < end:
                time.sleep(0.005)
        return item
    return get_held


def _profiler(cuda: bool):
    """A profiler of the card's activity (kernels, copies, sets from every
    thread; the CPU's ops are not recorded, which keeps its cost off the
    driver's threads), or of the CPU's ops where there is no card."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def json_cmd(kwargs: dict) -> str:
    """A command block's update message carrying ``kwargs``."""
    return json.dumps({"id": "xbench", "cmd": "update",
                       "val": {"kwargs": kwargs}})


def _sleep_until(t: float) -> None:
    while True:
        dt = t - time.perf_counter()
        if dt <= 0:
            return
        time.sleep(min(dt, 0.5))
