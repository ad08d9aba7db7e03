"""FX benchmark on one GPU: raw ADC -> PFB -> 4-bit requant -> X/B step
(port of ``caltech_bifrost_dsp_tpu/scripts/bench_fx.py``).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_fx [--adc-dtype int8]
    python -m caltech_bifrost_dsp_tpu_torch.scripts.bench_fx --fengine

The default mode times :func:`..models.xengine.fx_step` on one window of
``--nspec`` spectra at the LWA-352 width; ``--fengine`` times the
channelizer alone at the F-engine operating point (4096 channels x 704
inputs, the factored DFT).  Each prints one JSON line with the JAX
script's keys (the ADC rate in Msamples/s per input and its ratio to the
real-time bar) plus the card's name and power limit.  Times come from
CUDA events around ``--niter`` calls after one warm-up call.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import LWA352


def _gen_adc(nadc: int, ninput: int, adc_dtype: str) -> np.ndarray:
    """Synthetic ADC block drawn at its final dtype: a float64
    intermediate would be 8x the int8 payload, gigabytes at F-engine
    scale."""
    rng = np.random.default_rng(0)
    if adc_dtype == "int8":
        return rng.integers(-90, 91, [nadc, ninput], dtype=np.int8)
    return rng.standard_normal([nadc, ninput], dtype=np.float32) * 3


def card() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi prints it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def cuda_ms(fn, niter: int) -> float:
    """Mean device ms per call of ``fn`` over ``niter`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(niter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / niter


def bench_fengine(args, dev) -> dict:
    """Channelizer + requant alone at the F-engine operating point; the
    real-time bar per input is fs = 196 MHz of ADC samples."""
    from ..ops import pfb_fused
    from ..ops.pfb import pfb_window

    nchan, ntap, ninput = args.nchan, LWA352.pfb_ntap, LWA352.ninput
    L = 2 * nchan
    adc = torch.from_numpy(_gen_adc((args.nspec + ntap - 1) * L, ninput,
                                    args.adc_dtype)).to(dev)
    window = torch.from_numpy(pfb_window(nchan, ntap)).to(dev)
    fast = args.pfb_precision == "bf16"
    ms = cuda_ms(lambda: pfb_fused.pfb_quantize_packed(
        adc, window, nchan, ntap, 0.5, fast), args.niter)
    msps = args.nspec * L / (ms * 1e-3) / 1e6
    return {"metric": "fengine_pfb_adc_rate_per_input", "value": msps,
            "unit": "Msamples/s", "vs_baseline": msps / (LWA352.fs_hz / 1e6),
            "nchan": nchan, "ntap": ntap, "ninput": ninput,
            "aggregate_gsps": msps * ninput / 1e3, "ms_per_call": ms,
            "nspec": args.nspec}


def bench_fx(args, dev) -> dict:
    """The FX step on one window at the LWA-352 width; the real-time bar
    per input is fs / npipeline ADC samples/s."""
    from ..models import xengine
    from ..ops.pfb import pfb_window

    cfg = LWA352.replace(pfb_precision=args.pfb_precision,
                         adc_dtype=args.adc_dtype)
    state, _, gains, pairs = xengine.default_inputs(cfg, device=dev)
    adc = torch.from_numpy(_gen_adc(
        (args.nspec + cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput,
        args.adc_dtype)).to(dev)
    window = torch.from_numpy(pfb_window(cfg.nchan, cfg.pfb_ntap)).to(dev)
    scale = torch.tensor(0.5, device=dev)
    # the packed bytes go to the X/B kernels in tci order: measured ~8 ms
    # per window faster than cti on an H100 80GB HBM3 at 700 W (PERF.md)
    ms = cuda_ms(lambda: xengine.fx_step(
        state, adc, window, scale, gains, pairs, True, True, False, cfg),
        args.niter)
    msps = args.nspec * 2 * cfg.nchan / (ms * 1e-3) / 1e6
    return {"metric": "fx_adc_rate_per_input", "value": msps,
            "unit": "Msamples/s",
            "vs_baseline": msps / (cfg.fs_hz / cfg.npipeline / 1e6),
            "aggregate_gsps": msps * cfg.ninput / 1e3, "ms_per_call": ms,
            "nspec": args.nspec}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="FX benchmark on one GPU")
    p.add_argument("--nspec", type=int, default=2400,
                   help="spectra per call (one fast accumulation)")
    p.add_argument("--niter", type=int, default=10)
    p.add_argument("--pfb-precision", type=str, default="high",
                   choices=["high", "bf16"])
    p.add_argument("--adc-dtype", type=str, default="float32",
                   choices=["float32", "int8"])
    p.add_argument("--fengine", action="store_true",
                   help="time the channelizer alone at the F-engine "
                        "operating point (4096 channels x 704 inputs)")
    p.add_argument("--nchan", type=int, default=4096,
                   help="F-engine channel count (with --fengine)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fx: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    row = bench_fengine(args, dev) if args.fengine else bench_fx(args, dev)
    name, limit = (x.strip() for x in card().split(",", 1))
    row.update(device=name, power_limit=limit, adc_dtype=args.adc_dtype,
               pfb_precision=args.pfb_precision)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
