"""A configuration's pipelines run as the deployment runs them: with
``pipelines_per_card`` 2, two pipeline processes on one card, as the
production unit ``deploy/cbd-torch-pipeline@.service`` starts pipelines
0 and 1 on one GPU.

:func:`run` takes any cell.  One pipeline runs in this process
(:func:`xbench.cell.run_cell`, nothing else in its way); two run in two
worker processes started with ``spawn`` (:func:`run_pair`).  Pipeline k
carries the configuration's ``pipeline_id`` + k (the next channel block)
and draws its pool, commands and sampled windows from
:func:`pipeline_seed` (``--seed``, k), so the two share no data.  This
process builds the kernel library and opens no CUDA context.  Each
worker runs the phases of :class:`xbench.cell.CellRun` for its pipeline
and reports its set-up done; both are then handed one Unix start time
``t0`` and run their windows over ``[t0, t0 + seconds)`` (a traced run
profiles the same slice of it in both), and compare one after the other,
so that two float64 references never hold host memory at once.

The pair's result line has the keys, in the order, of one pipeline's:

- ``realtime_factor``: the slower pipeline's, since the card keeps up
  only if both do; ``device_peak_gib`` and ``device.memory_peak_bytes``:
  the sum of the two processes' ``max_memory_allocated`` (each without
  its CUDA context); ``setup_s``: from this process's start to ``t0``;
- ``correct`` only where both comparisons pass; ``attempted`` and
  ``failed`` summed; each number of ``checks`` the worse of the two
  pipelines' values against its limit; ``device.count`` 1;
- the device trace: both processes' kernels and copies in one
  :class:`xbench.trace.Trace` over the slice both profiled, with the
  windows both stepped inside that slice, so the device-trace metrics,
  ``busy_s``, ``window_s`` and the ``breakdown`` read the card, not one
  context.  Without MPS the card time-slices between the two contexts,
  so a kernel's span takes in the other's turns: a kernel's seconds are
  the wall time its spans cover, counted once (:meth:`Trace.kernel_s`),
  and read contended time, not the kernel alone.  Its idle gaps are
  named by both processes' spans, each label prefixed ``p0.`` or
  ``p1.``;
- each host-side per-layer metric (``host_clock``, ``program_counter``,
  ``program_span``) the worse pipeline's, by the ``better`` that
  ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import time
import traceback

import numpy as np

from . import spec
from .cell import (CellRun, Readings, end_to_end, per_layer,
                   result_line, run_cell)
from .reference.check import Check
from .trace import Trace

#: what a worker gets of the cell, the rest resolved there
#: (:func:`xbench.spec.resolve`'s arguments)
PLAIN = ("name", "workload", "config", "traffic")
#: seconds from handing the workers their start time to the start
START_MARGIN_S = 0.25
#: seconds a worker may take for its set-up (the warm-up alone may take
#: 900), to drain after its window, and for its comparison
SETUP_TIMEOUT_S = 1200
DRAIN_TIMEOUT_S = 400
COMPARE_TIMEOUT_S = 600


def pipeline_seed(seed: int, k: int) -> int:
    """The seed of pipeline ``k`` of a pair, drawn from ``seed`` and k."""
    return int(np.random.SeedSequence([seed, k]).generate_state(
        1, np.uint64)[0] >> 1)


def run(c: dict, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        override: dict | None = None, t_start: float | None = None,
        log=print) -> dict:
    """Run cell ``c`` once, as many pipelines on its card as its
    configuration's ``pipelines_per_card``; the arguments and the result
    as :func:`xbench.cell.run_cell`'s."""
    kw = dict(device=device, control=control, override=override,
              t_start=t_start, log=log)
    if spec.pipelines_per_card(c["config"]) == 1:
        return run_cell(c, seed, seconds, trace, **kw)
    return run_pair(c, seed, seconds, trace, **kw)


def run_pair(c: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             override: dict | None = None, t_start: float | None = None,
             log=print) -> dict:
    """Run cell ``c``'s pipelines in worker processes over one common
    window and return the combined result line (the module's rules)."""
    t_start = time.perf_counter() if t_start is None else t_start
    n = spec.pipelines_per_card(c["config"])
    if device.startswith("cuda"):
        # the workers load the library this process builds
        from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build
        _build.build()
    plain = {k: c[k] for k in PLAIN}
    ctx = mp.get_context("spawn")
    conns: list = []
    procs: list = []
    done = False
    try:
        for k in range(n):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_worker, name=f"xbench-p{k}", args=(
                theirs, plain, k, seed, seconds, trace, device, control,
                override))
            proc.start()
            theirs.close()
            conns.append(ours)
            procs.append(proc)
        for conn, proc in zip(conns, procs):
            _receive(conn, proc, "ready", SETUP_TIMEOUT_S)
        now = time.perf_counter()
        t0 = time.time() + START_MARGIN_S
        setup_s = now + START_MARGIN_S - t_start
        for conn in conns:
            conn.send(t0)
        parts = [_receive(conn, proc, "window",
                          START_MARGIN_S + seconds + DRAIN_TIMEOUT_S)
                 for conn, proc in zip(conns, procs)]
        for part, conn, proc in zip(parts, conns, procs):
            conn.send("compare")
            part.update(_receive(conn, proc, "compare", COMPARE_TIMEOUT_S))
        done = True
    finally:
        for conn in conns:
            conn.close()
        for proc in procs:
            # a worker ends once it has sent its comparison; after a
            # failure the others are stopped
            proc.join(timeout=60 if done else 0)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    return combine(c, parts, setup_s, trace, log)


def combine(c: dict, parts: list, setup_s: float, trace: bool,
            log=print) -> dict:
    """One result line from the pipelines' ``parts`` (each its
    ``readings``, ``peak``, ``device``, the Unix ns of its fast ``dumps``,
    ``checks``, ``attempted``, ``failed`` and ``forbidden`` modules), by
    the module's rules."""
    found = sorted({m for p in parts for m in p["forbidden"]})
    if found:
        raise RuntimeError(f"forbidden modules loaded in a pipeline "
                           f"process: {', '.join(found)}")
    rs = [p["readings"] for p in parts]
    peak = sum(p["peak"] for p in parts)
    rtf = min(r.rtf for r in rs)
    log(f"xbench: pair: realtime_factor {[r.rtf for r in rs]!r}, the "
        f"card's {rtf!r}; peaks {[p['peak'] for p in parts]!r} bytes, "
        f"{peak} in all")
    worst: dict = {}
    for p in parts:
        for ch in p["checks"]:
            # a failing value (NaN among them) is never replaced by one
            # that passes
            w = worst.get(ch.name)
            if w is None or (w.ok and not ch.ok) or (
                    w.ok == ch.ok and ch.value > w.value):
                worst[ch.name] = ch
    checks = [Check(ch.name, worst[ch.name].value, ch.limit)
              for ch in parts[0]["checks"]]
    attempted = sum(p["attempted"] for p in parts)
    failed = sum(p["failed"] for p in parts)
    spans = [(f"p{k}.{s[0]}", *s[1:]) for k, r in enumerate(rs)
             for s in r.spans]
    card = None
    if trace:
        for k, r in enumerate(rs):
            t = r.trace
            log(f"xbench: p{k} profiled {len(t.kernels)} kernels and "
                f"{len(t.copies)} copies, busy {t.busy_s:.4f} of "
                f"{t.window_s:.4f} s")
        t0_ns = max(r.trace.t0_ns for r in rs)
        t1_ns = min(r.trace.t1_ns for r in rs)
        windows = sum(t0_ns <= d < t1_ns for p in parts for d in p["dumps"])
        card = Readings(rs[0].p, rs[0].fx, min(r.seconds for r in rs),
                        max(r.t0_ns for r in rs), min(r.t1_ns for r in rs),
                        trace=Trace.merged([r.trace for r in rs], windows))
        log(f"xbench: the card busy {card.trace.busy_s:.4f} of "
            f"{card.trace.window_s:.4f} s of the common slice, "
            f"{windows} windows stepped in it")
        better = spec.betters()

        def read(m, name):
            if m.SOURCE == "device_trace":
                return m.read(card)
            vals = [v for v in map(m.read, rs) if v is not None]
            pick = max if better[name] == "lower" else min
            return pick(vals) if vals else None

        metrics = per_layer(c, None, read)
    else:
        metrics = end_to_end(c, rtf, peak, setup_s)
    devinfo = dict(parts[0]["device"], memory_peak_bytes=int(peak))
    return result_line(checks, attempted, failed, metrics, devinfo,
                       card and card.trace, spans)


def _receive(conn, proc, want: str, timeout: float):
    """The body of worker ``proc``'s next message, which has to be
    ``want``; raises where it reports an error, ends or stays silent."""
    ready = mp.connection.wait([conn, proc.sentinel], timeout)
    if not ready:
        raise TimeoutError(f"{proc.name} sent no {want!r} within "
                           f"{timeout} s")
    try:
        what, body = conn.recv()
    except EOFError:
        proc.join(timeout=10)
        raise RuntimeError(f"{proc.name} ended (exit code {proc.exitcode}) "
                           f"before {want!r}") from None
    if what == "error":
        raise RuntimeError(f"{proc.name} failed:\n{body}")
    if what != want:
        raise RuntimeError(f"{proc.name} sent {what!r}, not {want!r}")
    return body


def pipeline(c: dict, k: int, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             override: dict | None = None, log=print) -> CellRun:
    """Pipeline ``k`` of cell ``c``'s pair, not yet set up: the
    configuration's ``pipeline_id`` + k, seeded by :func:`pipeline_seed`."""
    xe = {**c["config"]["xengine"], **(override or {})}
    return CellRun(c, pipeline_seed(seed, k), seconds, trace, device,
                   control, {**(override or {}),
                             "pipeline_id": xe.get("pipeline_id", 0) + k},
                   log=log)


def _worker(conn, plain: dict, k: int, seed: int, seconds: float,
            trace: bool, device: str, control: bool,
            override: dict | None) -> None:
    """Pipeline ``k`` of a pair, in a process of its own: set-up, the
    window from the start time the parent hands it, the comparison when
    the parent asks for it; each phase's outcome sent on ``conn``."""
    from .run import forbidden_modules

    def log(s: str) -> None:
        print(f"p{k} {s}", flush=True)

    try:
        run = pipeline(spec.resolve(*(plain[key] for key in PLAIN)), k,
                       seed, seconds, trace, device, control, override, log)
        run.setup()
        dumps: list = []
        run.pipe._emit = _stamped(run.pipe, dumps)
        conn.send(("ready", None))
        run.window(start_unix=conn.recv())
        conn.send(("window", {"readings": run.readings, "peak": run.peak,
                              "device": run.device_info(run.peak),
                              "dumps": dumps}))
        conn.recv()
        checks, attempted, failed = run.compare()
        conn.send(("compare", {"checks": checks, "attempted": attempted,
                               "failed": failed,
                               "forbidden": forbidden_modules()}))
    except Exception:  # noqa: BLE001 - reported to the parent, which raises
        try:
            conn.send(("error", traceback.format_exc()))
        except OSError:
            pass  # the parent has closed its end: it failed already
    finally:
        conn.close()


def _stamped(pipe, dumps: list):
    """``pipe._emit`` appending to ``dumps`` the Unix ns of each call that
    counts a fast dump (``ndump_fast``, which a trace's ``windows`` count),
    so that the parent counts a pair's windows in the common slice."""
    emit = pipe._emit

    def call(*a, **kw):
        n = pipe.ndump_fast
        try:
            return emit(*a, **kw)
        finally:
            if pipe.ndump_fast > n:
                dumps.append(time.time_ns())
    return call
