"""X-engine pipeline CLI for the PyTorch port.

The analog of ``caltech_bifrost_dsp_tpu/scripts/pipeline.py`` for its
geometry, golden-verification and FX flags: a synthetic source feeds
:class:`..runtime.runner.XEngineRunner`, and ``--testdatacorr`` gates every
slow dump by exact equality (exit 1 on a mismatch).  ``--fx`` feeds raw
ADC samples (noise, or a tone with ``--fx-tone-chan``) through the PFB
channelizer in front of the X/B step.  UDP capture, sinks and the control
plane are not ported yet, so ``--fakesource`` is required;
``--save-slow`` keeps the last slow dump as an ``.npz`` file.

Examples::

  # golden-vector verification run on the GPU
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --testdatain in.dat --testdatacorr corr.dat --ngulp 2000

  # the same on the CPU, through the plain versions of the kernels
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --testdatain in.dat --testdatacorr corr.dat --ngulp 20 --device cpu

  # FX mode: a tone in channel 9 through the channelizer, on the CPU
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --fx --fx-tone-chan 9 --nstand 8 --nchan 32 --ntime_gulp 48 \\
      --acc_len 96 --acc_len_slow 192 --nbeam 4 --ngulp 8 --device cpu \\
      --save-slow slow.npz
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from caltech_bifrost_dsp_tpu.config import LWA352, XEngineConfig

from ..io.source import ADCSource, SyntheticSource
from ..runtime.runner import XEngineRunner


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LWA-352 X-engine pipeline (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-c", "--nchan", type=int, default=LWA352.nchan)
    p.add_argument("--nstand", type=int, default=LWA352.nstand)
    p.add_argument("--nbeam", type=int, default=LWA352.nbeam)
    p.add_argument("-a", "--acc_len", type=int, default=LWA352.acc_len)
    p.add_argument("--acc_len_slow", type=int,
                   default=LWA352.acc_len_slow)
    p.add_argument("-t", "--ntime_gulp", type=int,
                   default=LWA352.ntime_gulp)
    p.add_argument("--autostartat", type=int, default=0)
    p.add_argument("--fakesource", action="store_true",
                   help="use the synthetic source (required: UDP capture "
                        "is not ported)")
    p.add_argument("--testdatain", type=str, default=None,
                   help="golden input .dat file to loop")
    p.add_argument("--testdatacorr", type=str, default=None,
                   help="golden correlation .dat for the equality gate")
    p.add_argument("--testdatacorr_acc_len", type=int, default=2400)
    p.add_argument("--ngulp", type=int, default=0,
                   help="stop after N gulps (0 = run forever)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs the kernels; cpu runs their plain "
                        "versions")
    p.add_argument("--save-slow", type=str, default=None, metavar="FILE",
                   help="write the last slow dump (real, imag int32 "
                        "[nchan, ninput, ninput]) to this .npz file")
    p.add_argument("--fx", action="store_true",
                   help="FX mode: the source provides raw ADC samples; "
                        "the step prepends PFB channelization")
    p.add_argument("--pfb-impl", type=str, default="matmul",
                   choices=["matmul", "fft"],
                   help="accepted for the JAX CLI's sake: both compute "
                        "the same transform through the one channelizer")
    p.add_argument("--pfb-precision", type=str, default="high",
                   choices=["high", "bf16"],
                   help="DFT operands in float32, or rounded to bf16")
    p.add_argument("--adc-dtype", type=str, default="float32",
                   choices=["float32", "int8"],
                   help="FX raw ADC sample dtype (int8 is the digitizer "
                        "width; same products for integer values)")
    p.add_argument("--quant-scale", type=float, default=1.0,
                   help="FX 4-bit requantization gain")
    p.add_argument("--eq-gains", type=str, default=None, metavar="FILE",
                   help="FX per-channel EQ gains: .npy or text file of "
                        "nchan positive floats (multiplied into "
                        "--quant-scale)")
    p.add_argument("--fx-tone-chan", type=int, default=-1,
                   help="FX fakesource: put a test tone in this channel")
    p.add_argument("--adc-amplitude", type=float, default=None,
                   help="FX fakesource amplitude in ADC units (default 4.0 "
                        "for float32, 32.0 for int8)")
    return p


def load_eq_gains(path: str | None, nchan: int):
    """--eq-gains FILE -> list of nchan positive floats (or None)."""
    if not path:
        return None
    gains = (np.load(path) if path.endswith(".npy")
             else np.loadtxt(path)).astype(float).ravel()
    if len(gains) != nchan or not np.all(gains > 0):
        raise ValueError(f"--eq-gains needs {nchan} positive values")
    return gains.tolist()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.fakesource:
        parser.error("--fakesource is required: UDP capture is not ported")
    if args.fx and (args.testdatain or args.testdatacorr):
        parser.error("--fx takes raw ADC samples; the golden test vectors "
                     "are packed post-F input")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu for the plain reference path)",
              file=sys.stderr)
        return 2
    cfg = XEngineConfig(nstand=args.nstand, nchan=args.nchan,
                        nbeam=args.nbeam, ntime_gulp=args.ntime_gulp,
                        acc_len=args.acc_len,
                        acc_len_slow=args.acc_len_slow,
                        pfb_fft_impl=args.pfb_impl,
                        pfb_precision=args.pfb_precision,
                        adc_dtype=args.adc_dtype)
    if args.fx:
        amp = args.adc_amplitude
        if amp is None:
            amp = 32.0 if args.adc_dtype == "int8" else 4.0
        if args.fx_tone_chan >= 0:
            src = ADCSource(cfg, mode="tone", tone_chan=args.fx_tone_chan,
                            amplitude=amp)
        else:
            src = ADCSource(cfg, mode="noise", amplitude=amp)
    elif args.testdatain:
        src = SyntheticSource(cfg, mode="testfile",
                              testfile=args.testdatain)
    else:
        src = SyntheticSource(cfg, mode="ramp")
    runner = XEngineRunner(cfg, device=args.device,
                           autostartat=args.autostartat,
                           checkfile=args.testdatacorr,
                           checkfile_acc_len=args.testdatacorr_acc_len,
                           fx=args.fx, quant_scale=args.quant_scale,
                           eq_gains=load_eq_gains(args.eq_gains, cfg.nchan))
    t0 = time.perf_counter()
    ncall = 0
    slow = None
    for products in runner.run(src.stream(args.ngulp)):
        ncall += 1
        if "vis_slow" in products:
            slow = products["vis_slow"]
    if args.save_slow and slow is not None:
        np.savez(args.save_slow, real=slow[0], imag=slow[1])
    print(f"{ncall} step calls, {runner.ndump_fast} fast dumps, "
          f"{runner.ndump_slow} slow dumps in "
          f"{time.perf_counter() - t0:.3f} s on {args.device}")
    if args.testdatacorr:
        print(f"golden check: {runner.check_count - runner.check_failures}"
              f"/{runner.check_count} passed")
        if runner.check_failures:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
