"""Golden input/output file generator CLI (port of
``caltech_bifrost_dsp_tpu/scripts/make_golden.py``).

Flag-compatible analog of reference: pipeline/verification/
make_golden_inputs.py (same defaults, same file naming, same RNG stream).
"""

from __future__ import annotations

import argparse
import sys
import time

from ..verification import golden


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Generate golden input / output files",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-t", "--ntime", type=int, default=480000)
    p.add_argument("-c", "--nchan", type=int, default=192)
    p.add_argument("-s", "--nstand", type=int, default=352)
    p.add_argument("-p", "--npol", type=int, default=2)
    p.add_argument("--accshort", type=int, default=2400)
    p.add_argument("--seed", type=int, default=golden.DEFAULT_SEED)
    p.add_argument("--nocorr", action="store_true")
    p.add_argument("--datapath", type=str, default="/data/")
    p.add_argument("--chanramp", action="store_true")
    args = p.parse_args(argv)

    assert args.ntime % args.accshort == 0, \
        "ntime must be a multiple of accshort"
    now = time.time()
    in_path = golden.input_filename(args.datapath, args.ntime, args.nchan,
                                    args.nstand, args.npol, args.seed,
                                    args.chanramp)
    golden.write_input_file(in_path, args.ntime, args.nchan, args.nstand,
                            args.npol, args.accshort, args.seed,
                            args.chanramp, timestamp=now)
    print("wrote", in_path)
    if not args.nocorr:
        corr_path = golden.corr_filename(
            args.datapath, args.ntime, args.accshort, args.nchan,
            args.nstand, args.npol, args.seed, args.chanramp)
        golden.write_corr_file(corr_path, args.ntime, args.nchan,
                               args.nstand, args.npol, args.accshort,
                               args.seed, args.chanramp, timestamp=now)
        print("wrote", corr_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
