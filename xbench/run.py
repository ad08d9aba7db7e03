"""Run one cell of the benchmark once and print its result line.

    python3 -m xbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--control]

With ``--trace 0`` the metrics are the end-to-end metrics the cell's
file lists (of ``realtime_factor``, ``device_peak_gib``, ``setup_s``);
with ``--trace 1`` its per-layer metrics, read over a profiled slice of
the window.
``--control`` runs the comparison's control instead of the program's
products (used to set the limits; the benchmark's own runs never pass
it).  The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
A configuration with ``pipelines_per_card`` 2 runs its two pipelines as
two processes on one card and prints their combined line
(:mod:`xbench.pair`).  Exits 2, printing no result, for a cell the
harness refuses; 1 without the CUDA devices the cell asks for or when a
module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level module names the process must not hold (compared whole)
FORBIDDEN = {"jax", "jaxlib", "flax", "caltech_bifrost_dsp_tpu"}


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = Path(__file__).resolve().parents[1]
    # the NVIDIA driver's JIT cache, at a fixed path in the checkout
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(root / ".xbench_cache" / "nv"))
    from xbench import pair, spec

    try:
        c = spec.cell(args.workload)
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"xbench: {e}", file=sys.stderr)
        return 2
    import torch

    need = int(c["workload"].get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"xbench: the cell needs {need} CUDA device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = pair.run(c, args.seed, args.seconds, bool(args.trace),
                   control=args.control, t_start=T_START,
                   log=lambda s: print(s, flush=True))
    found = forbidden_modules()
    if found:
        print(f"xbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for name, ch in out["checks"].items():
        print(f"check {name} {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
