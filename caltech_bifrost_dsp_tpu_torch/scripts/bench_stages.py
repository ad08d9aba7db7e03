"""Per-stage speed-of-light bench on one GPU at the production operating
point (port of ``caltech_bifrost_dsp_tpu/scripts/bench_stages.py``).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_stages \\
        [--niter N] [--stages a,b,...]

Times each stage alone at the full LWA-352 shape (2400 spectra x 192
channels x 704 inputs, 32 beams; the reference's fixed operating point,
install_xgpu.sh:5) with CUDA events over ``--niter`` calls after one
warm-up call, and holds it against the least time an H100 could take for
the same work (:mod:`..utils.roofline`: bytes over the memory rate or
operations over the peak rate of their type, whichever is larger).
Inputs are drawn on the card from a seed.  The stages keep the JAX
script's names, each on the port's counterpart:

- ``pfb_fused_bf16``, ``pfb_fused_high``, ``pfb_fused_bf16_int8``:
  ``ops/pfb_fused.py::pfb_direct`` (the direct channelizer kernel) with
  bf16 or float32 operands, float32 or int8 ADC; bound
  :func:`..utils.roofline.pfb_work` (int8 is ``PERF.md`` row 10's);
- ``pfb_fft_high_int8``: ``ops/pfb_fused.py::pfb_fft`` (the factored real
  FFT in float64, the float32 mode's kernel at this length) on the int8
  ADC, bound as ``pfb_fused_bf16_int8``;
- ``corr_window``: ``ops/correlate.py::correlate_accumulate`` on CUDA
  tensors, the plain float64 contraction (a library yardstick, no kernel
  of the port's).  Its model counts the packed window in and the two dense
  int32 planes out, and 4 real multiply-adds per sample, channel and input
  pair i <= j (what the function needs; the plain version computes both
  triangles) at the FP64 tensor-core rate;
- ``beamform_power``: ``beamform_gulp`` + ``beam_power_sum``, the plain
  float64 beams and powers.  Its model counts the packed window and
  float32 gains in, the powers out (no VLBI), and 8 operations per
  channel, sample, beam and input at the FP64 tensor-core rate;
- ``subsel``, ``subsel_pallas``, ``subsel_bands``: ``corr_subsel`` and
  ``corr_subsel_engine`` with each engine name, all the gather kernel
  (``PERF.md`` row 3), on the default and the production selection;
- ``slow_accum``: ``ops/correlate.py::long_accumulate``, the int32 add of
  a fast dump into the slow planes; its model counts bytes only (two
  operands of two [nchan, ninput, ninput] planes read, two planes
  written).  The operands are distinct: the JAX script adds one to itself,
  which reads it once and so runs faster than this bound allows;
- ``corr_blk_acc``: ``ops/corr_acc.py::corr_acc`` (the default
  unpack-once pair) with the flags that read and write all four state
  planes (``PERF.md`` rows 1 and 7);
- ``beamform_fused``: ``ops/beamform.py::beamform_products`` (``PERF.md``
  row 2).

Each row has ``stage``, ``measured_ms``, ``roofline_ms``, ``binding``
("bytes", or the type of the operations: int8, bf16, fp64 on the tensor
cores, fp32 outside them), ``sol_fraction`` (roofline over measured),
``bytes_ms`` and ``ops_ms``.  The peaks are the H100 SXM's; the memory
rate and the tensor-core rates are flags.  The JAX script's TPU peak flags (``--tflops``,
``--vpu-tops``) have no counterpart; ``--pfb-chunks``, a Mosaic
scheduling knob, is accepted and ignored.

Prints one JSON document with the shape, the peaks, the card's name
(``platform``, ``device``) and power limit and the rows.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import LWA352
from ..ops import beamform as bf
from ..ops import corr_subsel as cs
from ..ops import correlate as corr
from ..ops import pfb as pfb_ops
from ..ops import pfb_fused
from ..ops.corr_acc import corr_acc
from ..utils import roofline as rl


def stage_models(cfg, nvis_default: int, nvis_prod: int) -> dict:
    """(bytes, operations, type) of each stage at ``cfg``."""
    T, C, I, B = cfg.acc_len, cfg.nchan, cfg.ninput, cfg.nbeam
    L, ntap = 2 * C, cfg.pfb_ntap
    adc = (T + ntap - 1) * L * I
    vis_bytes = 2 * C * I * I * 4
    pfb_f32 = rl.pfb_work(4 * adc, I, T, C, ntap)
    return {
        "pfb_fused_bf16": pfb_f32,
        "pfb_fused_high": pfb_f32,
        "pfb_fused_bf16_int8": rl.pfb_work(adc, I, T, C, ntap),
        "pfb_fft_high_int8": rl.pfb_work(adc, I, T, C, ntap),
        "corr_window": (T * C * I + vis_bytes,
                        8 * C * T * I * (I + 1) / 2, "fp64"),
        "beamform_power": rl.beamform_work(C, T, I, B, cfg.ntime_sum,
                                           vlbi=False, kind="fp64"),
        "subsel": rl.subsel_work(nvis_default, C, cfg.nchan_sum),
        "subsel_pallas": rl.subsel_work(nvis_default, C, cfg.nchan_sum),
        "subsel_bands": rl.subsel_work(nvis_prod, C, cfg.nchan_sum),
        "slow_accum": (3 * vis_bytes, 0, "fp32"),
        "corr_blk_acc": rl.corr_work(C, T, I, 64, 4, 4),
        "beamform_fused": rl.beamform_work(C, T, I, B, cfg.ntime_sum),
    }


def stage_calls(cfg, dev, seed: int = 1) -> tuple[dict, tuple]:
    """Each stage as a call on inputs drawn on ``dev``, and the pair
    counts of the default and the production selection."""
    T, C, I, B = cfg.acc_len, cfg.nchan, cfg.ninput, cfg.nbeam
    L, ntap = 2 * C, cfg.pfb_ntap
    g = torch.Generator(device=dev).manual_seed(seed)
    packed = torch.randint(0, 256, (T, C, I), generator=g, device=dev,
                           dtype=torch.uint8)
    adc = torch.randn(((T + ntap - 1) * L, I), generator=g,
                      device=dev) * 3
    adc8 = torch.clamp(torch.round(adc * 10), -127, 127).to(torch.int8)
    window = torch.from_numpy(pfb_ops.pfb_window(C, ntap)).to(dev)
    gains = bf.BeamGains(*(torch.randn((C, B, I), generator=g, device=dev)
                           for _ in range(2)))

    def planes():
        return torch.randint(-1 << 20, 1 << 20, (C, I, I), generator=g,
                             device=dev, dtype=torch.int32)

    vis = corr.Vis(planes(), planes())
    fast, slow = corr.Vis(planes(), planes()), corr.Vis(planes(), planes())

    def pairs(baselines):
        return torch.from_numpy(cs.baselines_to_inputs(baselines).astype(
            np.int32)).to(dev)

    default = pairs(cs.default_baselines(cfg.nvis_out, cfg.nstand))
    prod = pairs(cs.production_baselines(cfg.nvis_out, cfg.nstand,
                                         cfg.npol))
    return {
        "pfb_fused_bf16": lambda: pfb_fused.pfb_direct(
            adc, window, C, ntap, 0.5, fast=True),
        "pfb_fused_high": lambda: pfb_fused.pfb_direct(
            adc, window, C, ntap, 0.5, fast=False),
        "pfb_fused_bf16_int8": lambda: pfb_fused.pfb_direct(
            adc8, window, C, ntap, 0.5, fast=True),
        "pfb_fft_high_int8": lambda: pfb_fused.pfb_fft(
            adc8, window, C, ntap, 0.5),
        "corr_window": lambda: corr.correlate_accumulate(packed, T),
        "beamform_power": lambda: bf.beam_power_sum(
            bf.beamform_gulp(packed, gains), cfg.ntime_sum),
        "subsel": lambda: cs.corr_subsel(vis, default, cfg.nchan_sum),
        "subsel_pallas": lambda: cs.corr_subsel_engine(
            vis, default, cfg.nchan_sum, "pallas"),
        "subsel_bands": lambda: cs.corr_subsel_engine(
            vis, prod, cfg.nchan_sum, "bands"),
        "slow_accum": lambda: corr.long_accumulate(vis, slow),
        "corr_blk_acc": lambda: corr_acc(packed, fast, slow, False, True,
                                         False),
        "beamform_fused": lambda: bf.beamform_products(
            packed, gains, cfg.ntime_sum),
    }, (default.shape[0], prod.shape[0])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="per-stage SOL bench on one GPU")
    p.add_argument("--niter", type=int, default=12)
    p.add_argument("--hbm", type=float, default=rl.HBM_BYTES_S / 1e9,
                   help="memory rate, GB/s (H100 SXM HBM3)")
    p.add_argument("--int8-tops", type=float,
                   default=rl.PEAK_OPS_S["int8"] / 1e12,
                   help="int8 tensor-core peak, TOP/s (H100 SXM, dense)")
    p.add_argument("--bf16-tflops", type=float,
                   default=rl.PEAK_OPS_S["bf16"] / 1e12,
                   help="bf16 tensor-core peak, TFLOP/s (H100 SXM, dense)")
    p.add_argument("--fp64-tflops", type=float,
                   default=rl.PEAK_OPS_S["fp64"] / 1e12,
                   help="FP64 tensor-core peak, TFLOP/s (H100 SXM)")
    p.add_argument("--stages", default="",
                   help="comma-separated subset to run")
    p.add_argument("--pfb-chunks", type=int, default=1,
                   help="accepted for the JAX script's sake and ignored: a "
                        "Mosaic scheduling knob with no counterpart")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stages: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = LWA352
    peaks = {"int8": args.int8_tops * 1e12, "bf16": args.bf16_tflops * 1e12,
             "fp64": args.fp64_tflops * 1e12, "fp32": rl.PEAK_OPS_S["fp32"]}
    hbm = args.hbm * 1e9
    calls, (nvis_default, nvis_prod) = stage_calls(cfg, dev)
    models = stage_models(cfg, nvis_default, nvis_prod)
    only = {s for s in args.stages.split(",") if s}
    unknown = only - set(calls)
    if unknown:
        p.error(f"unknown stages {sorted(unknown)}")
    rows = []
    for name, fn in calls.items():
        if only and name not in only:
            continue
        ms = rl.cuda_ms(fn, args.niter)
        nbyte, nop, kind = models[name]
        b = rl.bound(nbyte, nop, kind, hbm, peaks)
        rows.append({"stage": name, "measured_ms": ms,
                     "roofline_ms": b["bound_ms"],
                     "binding": "bytes" if b["bound_by"] == "bytes"
                     else kind,
                     "sol_fraction": b["bound_ms"] / ms,
                     "bytes_ms": nbyte / hbm * 1e3,
                     "ops_ms": nop / peaks[kind] * 1e3})
        print(f"{name}: {ms:.3f} ms measured, SOL {b['bound_ms']:.3f} ms "
              f"({rows[-1]['binding']}-bound, "
              f"{rows[-1]['sol_fraction'] * 100:.1f}% of SOL)",
              file=sys.stderr)
    print(json.dumps({
        "metric": "stage_speed_of_light",
        "shape": {"nspec": cfg.acc_len, "nchan": cfg.nchan,
                  "ninput": cfg.ninput, "nbeam": cfg.nbeam},
        "peaks": {"hbm_gbps": args.hbm, "int8_tops": args.int8_tops,
                  "bf16_tflops": args.bf16_tflops,
                  "fp64_tflops": args.fp64_tflops,
                  "fp32_tflops": peaks["fp32"] / 1e12},
        "platform": torch.cuda.get_device_name(0), **rl.card_fields(),
        "stages": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
