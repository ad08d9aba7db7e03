"""Arm the correlator across pipelines (port of
``caltech_bifrost_dsp_tpu/scripts/arm_correlator.py``).

The reference's pipeline-control/scripts/lwa352_arm_correlator.py: sets
the output destination and throttle, then the two-phase arm::

  python -m caltech_bifrost_dsp_tpu_torch.scripts.arm_correlator \\
      --etcdhost kv://127.0.0.1:4440 --hosts $(hostname) --delay 5
"""

from __future__ import annotations

import argparse
import sys

from ..control.client import (CorrControlClient, CorrelatorControl,
                              PipelineControl)
from ..control.store import connect


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Arm the X-engine correlator (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--etcdhost", type=str, default=None)
    p.add_argument("--hosts", type=str, default="localhost",
                   help="comma-separated pipeline hosts")
    p.add_argument("--pipelines", type=int, default=1,
                   help="pipelines per host")
    p.add_argument("-d", "--delay", type=float, default=5.0,
                   help="seconds in the future to start")
    p.add_argument("-a", "--acc_len", type=int, default=None)
    p.add_argument("--dest_ip", type=str, default=None)
    p.add_argument("--dest_port", type=int, default=10001)
    p.add_argument("--max_mbps", type=int, default=1500)
    args = p.parse_args(argv)

    store = connect(args.etcdhost)
    cli = CorrControlClient(store=store)
    pls = [PipelineControl(cli, h, i)
           for h in args.hosts.split(",")
           for i in range(args.pipelines)]
    corr = CorrelatorControl(cli, pls)
    if args.dest_ip:
        for pl in pls:
            pl.corr_output_full.set_destination(args.dest_ip,
                                                args.dest_port)
            pl.corr_output_full.set_max_mbps(args.max_mbps)
    start = corr.arm_and_wait(delay_s=args.delay, acc_len=args.acc_len)
    print("armed at spectra", start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
