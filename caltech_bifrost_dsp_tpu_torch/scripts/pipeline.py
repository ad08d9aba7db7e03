"""X-engine pipeline CLI for the PyTorch port.

The analog of ``caltech_bifrost_dsp_tpu/scripts/pipeline.py`` for its
geometry and golden-verification flags: a synthetic source feeds
:class:`..runtime.runner.XEngineRunner`, and ``--testdatacorr`` gates every
slow dump by exact equality (exit 1 on a mismatch).  UDP capture, sinks and
the control plane are not ported yet, so ``--fakesource`` is required.

Examples::

  # golden-vector verification run on the GPU
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --testdatain in.dat --testdatacorr corr.dat --ngulp 2000

  # the same on the CPU, through the plain versions of the kernels
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --testdatain in.dat --testdatacorr corr.dat --ngulp 20 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from caltech_bifrost_dsp_tpu.config import LWA352, XEngineConfig

from ..io.source import SyntheticSource
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
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.fakesource:
        parser.error("--fakesource is required: UDP capture is not ported")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu for the plain reference path)",
              file=sys.stderr)
        return 2
    cfg = XEngineConfig(nstand=args.nstand, nchan=args.nchan,
                        nbeam=args.nbeam, ntime_gulp=args.ntime_gulp,
                        acc_len=args.acc_len,
                        acc_len_slow=args.acc_len_slow)
    if args.testdatain:
        src = SyntheticSource(cfg, mode="testfile",
                              testfile=args.testdatain)
    else:
        src = SyntheticSource(cfg, mode="ramp")
    runner = XEngineRunner(cfg, device=args.device,
                           autostartat=args.autostartat,
                           checkfile=args.testdatacorr,
                           checkfile_acc_len=args.testdatacorr_acc_len)
    t0 = time.perf_counter()
    ncall = 0
    for _ in runner.run(src.stream(args.ngulp)):
        ncall += 1
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
