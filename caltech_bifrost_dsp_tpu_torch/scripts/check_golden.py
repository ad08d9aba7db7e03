"""Re-verify golden vector files by brute force (port of
``caltech_bifrost_dsp_tpu/scripts/check_golden.py``).

Parity with reference: pipeline/verification/check_golden_inputs.py —
reads an input ``.dat`` and its correlation ``.dat`` and recomputes every
integration block, reporting exact-match status.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..verification import golden


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Brute-force check of golden vector files")
    p.add_argument("input_file")
    p.add_argument("corr_file")
    p.add_argument("--max-blocks", type=int, default=0,
                   help="check only the first N blocks (0 = all)")
    args = p.parse_args(argv)

    meta_in, din = golden.read_dat(args.input_file)
    meta_corr, dcorr = golden.read_dat(args.corr_file)
    acc = meta_corr["acc_len"]
    nblock = meta_corr["ntime"]
    if args.max_blocks:
        nblock = min(nblock, args.max_blocks)
    nbad = 0
    for t in range(nblock):
        block = din[t * acc:(t + 1) * acc]
        want = golden.reference_correlation(block)
        if not np.array_equal(want, dcorr[t]):
            print(f"block {t}: MISMATCH")
            nbad += 1
        else:
            print(f"block {t}: ok")
    print(f"{nblock - nbad}/{nblock} blocks verified")
    return 1 if nbad else 0


if __name__ == "__main__":
    sys.exit(main())
