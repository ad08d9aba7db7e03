"""Device time of the baseline-subselection gather (``csrc/subsel_gather.cu``)
at the production shape, apart from the host's launch cost.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_subsel \\
        [--source OTHER.cu ...]

Builds with nvcc the repository's gather, variants of it (a few lines
replaced: other block sizes, 4-byte stores, the plane loads cut) and any
other source with the same ``cbd_subsel_gather`` launcher (e.g. an earlier
version of the file), prints the compiler's registers and spills, checks
each exactly against ``ops/corr_subsel.py::corr_subsel_ref`` on 704 inputs x
192 channels summed by 4 and the 4704 production baselines plus one
malformed pair (the variant without plane loads computes wrong sums on
purpose and is not checked), and times each, in turns (A B ... B A):

- ``graph``: a CUDA graph of 100 bare launches on preallocated outputs,
  replayed under CUDA events: the device alone, L2 warm (the 7.2 MB the
  gather reads stay in the 50 MB L2 from one launch to the next);
- ``cold write``: one bare launch between CUDA events after a 256 MB write
  (L2 full of dirty lines, as the correlator leaves it), median of 30;
- ``cold read``: the same after a 256 MB read (L2 clean);
- ``cold, TLB warm``: after the read and a read of the last row of every
  channel of both planes (their pages mapped, the gathered rows not in L2);
- ``loop``: 100 bare launches back to back from Python under CUDA events.

Then the wrapper ``ops/corr_subsel.py::corr_subsel`` (checks, two
``torch.empty``, a ``ctypes`` launch): CUDA events over 20 calls, and the
host's time per call.  Prints the byte bound and the shares, and one JSON
line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import corr_subsel as cs
from ..ops.correlate import Vis
from ..ops.kernels import _build

HBM_BYTES_S = 3.35e12
NCHAN, NINPUT, NCHAN_SUM = 192, 704, 4


def production_pairs() -> np.ndarray:
    """The 4704 production baselines of 352 stands, then one malformed
    pair (stand 400)."""
    return np.concatenate([
        cs.baselines_to_inputs(cs.production_baselines(4704, 352)),
        cs.baselines_to_inputs([[[400, 0], [3, 1]]])]).astype(np.int32)


def byte_bound_ms(nvis: int, nchan: int, nchan_sum: int) -> float:
    """Both planes read at every selected entry, written once per output
    channel, and the pairs read once, over the memory rate."""
    nbyte = 8 * nvis * (nchan + nchan // nchan_sum + 1)
    return nbyte / HBM_BYTES_S * 1e3


#: name -> (text replacements in the repository's source, exact?)
VARIANTS = {
    "as built": ([], True),
    "128-thread blocks": ([("constexpr int THREADS = 64;",
                            "constexpr int THREADS = 128;")], True),
    "256-thread blocks": ([("constexpr int THREADS = 64;",
                            "constexpr int THREADS = 256;")], True),
    "4-byte stores": ([("if (vector_stores && f0 + K <= nout) {",
                        "if (false) {")], True),
    "no plane loads": ([
        ("r[k][s] = live ? __ldg(vis_r + o) : 0;",
         "r[k][s] = live ? static_cast<int>(o) : 0;"),
        ("im[k][s] = live ? __ldg(vis_i + o) : 0;",
         "im[k][s] = live ? static_cast<int>(o >> 1) : 0;")], False),
}


def variant_source(edits: list) -> str:
    src = (_build.CSRC / "subsel_gather.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"subsel_gather.cu no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build(source: Path, so: Path) -> tuple[ctypes.CDLL, str]:
    """Compile one gather source into its own library ``so``; returns it
    and the ptxas lines of its kernels."""
    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    report = [line.split(":", 1)[-1].strip()
              for line in (proc.stdout + proc.stderr).splitlines()
              if "registers" in line or "spill" in line]
    lib = ctypes.CDLL(str(so))
    lib.cbd_subsel_gather.argtypes = _build.SIGNATURES["cbd_subsel_gather"]
    lib.cbd_subsel_gather.restype = ctypes.c_int
    return lib, "; ".join(report)


def bare_launch(fn, vis: Vis, pairs: torch.Tensor, nchan_sum: int,
                out: Vis):
    """A closure that launches ``fn`` (a ``cbd_subsel_gather``) on the
    current stream into ``out``, with no check and no allocation."""
    nchan, ninput, _ = vis.real.shape
    args = (vis.real.data_ptr(), vis.imag.data_ptr(), nchan, ninput,
            pairs.data_ptr(), pairs.shape[0], nchan_sum, out.real.data_ptr(),
            out.imag.data_ptr())

    def launch(keep=(vis, pairs, out)):  # the tensors outlive the closure
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cbd_subsel_gather: CUDA error {rc}")

    return launch


def graph_ms(launch, n: int = 100, reps: int = 10) -> float:
    """Device time per launch: ``n`` launches captured in a CUDA graph,
    replayed ``reps`` times under CUDA events."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                launch()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def cold_ms(launch, prepare, reps: int = 30) -> float:
    """Median time of one launch between CUDA events after ``prepare``."""
    times = []
    for _ in range(reps):
        prepare()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def evictions(vis: Vis) -> dict:
    """The ways of emptying L2 before a ``cold`` launch."""
    flush = torch.empty(64 << 20, dtype=torch.int32, device=vis.real.device)
    flush.fill_(1)

    def tlb():
        flush.sum()
        for plane in vis:
            plane[:, -1].sum()

    return {"cold write": lambda: flush.fill_(1),
            "cold read": lambda: flush.sum(), "cold, TLB warm": tlb}


def loop_ms(launch, n: int = 100) -> float:
    """Back-to-back launches from Python under CUDA events, per launch."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def wrapper_ms(vis: Vis, pairs: torch.Tensor, nchan_sum: int,
               n: int = 20) -> tuple[float, float]:
    """The wrapper ``corr_subsel``: CUDA-event ms per call over ``n``
    calls, and the host's ms per call (enqueue, over 200 calls)."""
    cs.corr_subsel(vis, pairs, nchan_sum)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        cs.corr_subsel(vis, pairs, nchan_sum)
    end.record()
    end.synchronize()
    events = start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(200):
        cs.corr_subsel(vis, pairs, nchan_sum)
    host = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    return events, host


def inputs(dev) -> tuple[Vis, torch.Tensor]:
    g = torch.Generator(device=dev).manual_seed(0x5B5E1)
    vis = Vis(*(torch.randint(-2 ** 20, 2 ** 20, (NCHAN, NINPUT, NINPUT),
                              generator=g, device=dev, dtype=torch.int32)
                for _ in range(2)))
    return vis, torch.from_numpy(production_pairs()).to(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", action="append", default=[],
                   help="another gather source with the same launcher")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_subsel: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    vis, pairs = inputs(dev)
    want = cs.corr_subsel_ref(vis, pairs, NCHAN_SUM)
    nco, nvis = NCHAN // NCHAN_SUM, pairs.shape[0]
    bound = byte_bound_ms(nvis, NCHAN, NCHAN_SUM)
    work = _build.BUILD_DIR / "probe_subsel"
    work.mkdir(parents=True, exist_ok=True)
    sources = {}
    for k, (name, (edits, exact)) in enumerate(VARIANTS.items()):
        cu = work / f"variant{k}.cu"
        cu.write_text(variant_source(edits))
        sources[name] = (cu, exact)
    for path in args.source:
        sources[path] = (Path(path), True)
    launches = {}
    for k, (name, (src, exact)) in enumerate(sources.items()):
        lib, report = build(src, work / f"gather{k}.so")
        print(f"ptxas {name}: {report}", flush=True)
        out = Vis(*(torch.full((nco, nvis), 0x5A5A5A5A, dtype=torch.int32,
                               device=dev) for _ in range(2)))
        launch = bare_launch(lib.cbd_subsel_gather, vis, pairs, NCHAN_SUM,
                             out)
        launch()
        torch.cuda.synchronize()
        if exact and not (torch.equal(out.real, want.real)
                          and torch.equal(out.imag, want.imag)):
            raise RuntimeError(f"{name}: gather != plain")
        print(f"{name}: {'exact' if exact else 'not checked'} against "
              f"corr_subsel_ref", flush=True)
        launches[name] = launch
    modes = evictions(vis)
    times = {name: {m: [] for m in ["graph", *modes, "loop"]}
             for name in launches}
    for name in list(launches) + list(reversed(launches)):
        launch = launches[name]
        times[name]["graph"].append(graph_ms(launch))
        for mode, prepare in modes.items():
            times[name][mode].append(cold_ms(launch, prepare))
        times[name]["loop"].append(loop_ms(launch))
    for name, t in times.items():
        print(f"[{card}] {name}: ms per launch; " + "; ".join(
            f"{mode} " + ", ".join(f"{x:.5f}" for x in xs)
            for mode, xs in t.items())
            + f"; byte bound {bound:.5f} ms, share (graph) "
            f"{bound / min(t['graph']):.2f}", flush=True)
    events, host = wrapper_ms(vis, pairs, NCHAN_SUM)
    print(f"[{card}] wrapper corr_subsel: {events:.5f} ms per call under "
          f"CUDA events, host {host:.5f} ms per call", flush=True)
    print(json.dumps({"card": card, "bound_ms": bound, "times": times,
                      "wrapper_ms": events, "wrapper_host_ms": host}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
