"""Scaling bench of the sharded FX step (port of
``caltech_bifrost_dsp_tpu/scripts/bench_scaling.py``).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_scaling \\
        [--production] [--meshes 1x1,1x2,2x2] [--niter N] [--cpu N]

Streams fast windows, gulp by gulp, through
``parallel/mesh.py::fx_sharded_state_fn`` (PFB -> halo exchange ->
corner-turn -> correlate -> beamform, the accumulators carried from call to
call, the psum and subselection on the dump gulp) at each mesh shape, and
reports Msamples/s per window and the scaling efficiencies: strong
scaling, the same problem at every shape.

Placement.  On the card (the default) the shards of a mesh go round robin
over the host's CUDA devices (``make_mesh(devices=...)``): on one card all
of them share ``cuda:0``, the analog of the JAX script's virtual mesh of
constant compute, and ``constant_compute_efficiency`` (aggregate rate over
the 1x1 rate) is the cost of sharding at a fixed budget: the collectives
as stream-ordered copies and the partition bookkeeping.
``per_chip_efficiency`` divides by the shard count, as the JAX script
does; ``cards`` says how many distinct cards ran.  ``--cpu N`` runs every
shard on the CPU device (the plain versions) with meshes of up to N
shards.  A window is timed on the host clock around calls that end in a
synchronize, after one window of warm-up.

Each row carries ``collective_bytes_per_device_per_window`` from
:func:`..parallel.mesh.collective_volumes`: the bytes each shard would
send if it had a device of its own.

Prints one JSON line with the JAX script's ``fx_scaling_strong`` keys
(``platform``, ``shape``, ``devices`` by mesh, ``per_chip_efficiency``,
``constant_compute_efficiency``) plus ``cards`` and the card's ``device``
and ``power_limit``.  Without ``--cpu`` it exits non-zero on a host without
a CUDA device.

The JAX package's ``scripts/tpu_parity.py`` has no counterpart here:
``chip_smoke.py`` is the port's parity gate on the card.  Its first path
runs the same checks (golden windows at 192 and 184 channels, fast, slow,
subselection and VLBI exact, power within rtol 1e-4) and its second the
FX leg.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import LWA352, XEngineConfig
from ..ops import beamform as bf
from ..ops import corr_subsel as cs
from ..ops import pfb as pfb_ops
from ..parallel import mesh as pmesh
from ..utils.roofline import card_fields


def measure(cfg, mesh, gulp_spectra: int, niter: int) -> float:
    """Seconds per fast window (``acc_len`` spectra) streamed through the
    stateful sharded FX step: ``acc_len / gulp_spectra`` calls a window,
    per-time-shard partial accumulation mid-window, psum and subselection
    on the dump gulp."""
    dev = mesh.devices[0][0]
    g = torch.Generator(device=dev).manual_seed(0)
    adc = torch.randn((gulp_spectra * 2 * cfg.nchan, cfg.ninput),
                      generator=g, device=dev)
    window = torch.from_numpy(pfb_ops.pfb_window(cfg.nchan,
                                                 cfg.pfb_ntap)).to(dev)
    gains = bf.BeamGains(
        torch.ones((cfg.nchan, cfg.nbeam, cfg.ninput), device=dev),
        torch.zeros((cfg.nchan, cfg.nbeam, cfg.ninput), device=dev))
    pairs = torch.from_numpy(cs.baselines_to_inputs(cs.default_baselines(
        cfg.nvis_out, cfg.nstand)).astype(np.int32)).to(dev)
    carry = torch.zeros(((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput),
                        device=dev)
    scale = torch.tensor(1.0, device=dev)
    gulps_per_window = cfg.acc_len // gulp_spectra

    def flags(k):
        return (k == 0, k == gulps_per_window - 1, True)

    steps = {}
    for k in range(gulps_per_window):
        if flags(k) not in steps:
            steps[flags(k)] = pmesh.fx_sharded_state_fn(cfg, mesh, *flags(k))

    def run_window(state):
        for k in range(gulps_per_window):
            state, _, _ = steps[flags(k)](state, adc, carry, window, scale,
                                          gains, pairs)
        return state

    def sync():
        if dev.type == "cuda":
            for d in {d for row in mesh.devices for d in row}:
                torch.cuda.synchronize(d)

    state = run_window(pmesh.zero_sharded_state(cfg, mesh))  # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(niter):
        state = run_window(state)
    sync()
    return (time.perf_counter() - t0) / niter


def placement(n: int, cpu: bool) -> list:
    """Devices of an n-shard mesh: the CPU, or the CUDA devices round
    robin."""
    if cpu:
        return ["cpu"] * n
    ncard = torch.cuda.device_count()
    return [torch.device("cuda", k % ncard) for k in range(n)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="FX scaling benchmark")
    p.add_argument("--cpu", type=int, default=0,
                   help="run on the CPU with meshes of up to N shards")
    p.add_argument("--nspec", type=int, default=0,
                   help="spectra per gulp (default: cfg.ntime_gulp; "
                        "fixed across mesh sizes)")
    p.add_argument("--niter", type=int, default=5)
    p.add_argument("--nstand", type=int, default=64)
    p.add_argument("--nchan", type=int, default=128)
    p.add_argument("--production", action="store_true",
                   help="run the full production operating point "
                        "(352 stands, 192 chan, 480-spectra gulp; the "
                        "reference's fixed shape, install_xgpu.sh:5)")
    p.add_argument("--meshes", default="",
                   help="explicit TxC mesh list, e.g. '1x1,1x2,2x2' "
                        "(default: powers of 2 with time<=2, up to the "
                        "device count)")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench_scaling: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False

    if args.production:
        cfg = LWA352
    else:
        cfg = XEngineConfig(
            nstand=args.nstand, nchan=args.nchan,
            ntime_gulp=48, acc_len=96, acc_len_slow=192, nbeam=8,
            ntime_sum=12, nchan_sum=4, npipeline=2, pfb_ntap=4)
    nspec = args.nspec or cfg.ntime_gulp  # one gulp per call

    ndev = args.cpu or torch.cuda.device_count()
    if args.meshes:
        shapes = [tuple(int(v) for v in m.split("x"))
                  for m in args.meshes.split(",")]
    else:
        shapes, n = [], 1
        while n <= ndev:
            shapes.append((2 if n % 2 == 0 else 1,
                           n // (2 if n % 2 == 0 else 1)))
            n *= 2
    results = {}
    for n_time, n_chan in shapes:
        n = n_time * n_chan
        if args.cpu and n > args.cpu:
            print(f"{n_time}x{n_chan}: needs {n} shards, --cpu {args.cpu}; "
                  "skipped", file=sys.stderr)
            continue
        if cfg.nchan % n_chan or cfg.ninput % n_chan or nspec % n_time:
            print(f"n={n}: shape not divisible, skipped", file=sys.stderr)
            continue
        devices = placement(n, bool(args.cpu))
        mesh = pmesh.make_mesh(n_time, n_chan, devices=devices)
        dt = measure(cfg, mesh, nspec, args.niter)
        samples = cfg.acc_len * cfg.nchan * cfg.ninput  # per window
        vols = pmesh.collective_volumes(cfg, n_time, n_chan,
                                        gulp_spectra=nspec)
        key = f"{n_time}x{n_chan}"
        results[key] = {
            "n": n, "cards": 0 if args.cpu else len(set(devices)),
            "sec_per_window": dt,
            "msamples_per_s": samples / dt / 1e6,
            "msamples_per_s_per_chip": samples / dt / 1e6 / n,
            "collective_bytes_per_device_per_window": {
                v["collective"]: (v["per_device_bytes_per_fire"]
                                  * v["fires_per_window"])
                for v in vols["collectives"]}}
        print(f"n={n} ({key}): {dt * 1e3:.1f} ms/window, "
              f"{results[key]['msamples_per_s']:.1f} Msamples/s "
              f"({results[key]['msamples_per_s_per_chip']:.1f}/shard)",
              file=sys.stderr)
    done = sorted(results, key=lambda k: (results[k]["n"], k))
    if not done:
        print(json.dumps({"metric": "fx_scaling_strong",
                          "error": "no mesh shape ran (too few devices "
                                   "or non-divisible shape); see stderr"}))
        return 1
    base = results[done[0]]
    out = {"metric": "fx_scaling_strong",
           "platform": "cpu" if args.cpu else "gpu",
           "shape": {"nstand": cfg.nstand, "nchan": cfg.nchan,
                     "nspec": nspec, "production": bool(args.production)},
           "devices": {k: results[k] for k in done},
           "per_chip_efficiency": {
               k: (results[k]["msamples_per_s_per_chip"]
                   / base["msamples_per_s_per_chip"]) for k in done},
           "constant_compute_efficiency": {
               k: results[k]["msamples_per_s"] / base["msamples_per_s"]
               for k in done},
           "cards": max(results[k]["cards"] for k in done)}
    if not args.cpu:
        out.update(card_fields())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
