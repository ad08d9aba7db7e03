"""Offline upchannelizing imaging-correlator CLI (port of
``caltech_bifrost_dsp_tpu/scripts/upchan_imag.py``: the same flags,
defaults and file, plus ``--device``).

Analog of reference: pipeline/scripts/lwa352-upchan-imag.py: replays a
triggered-dump file, upchannelizes, selects a fine-channel range,
integrates visibilities and writes them to HDF5.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.upchan_imag \\
        --datain lwa-dump_0_0.tbf --output vis.h5 --nupchan 2 \\
        --start-freq 0 --end-freq 384 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.hdf5 import VisibilityHDF5Writer
from ..io.source import TriggerFileSource
from ..models import offline
from .upchan_bf import no_card


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Offline upchannelize + correlate",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--datain", required=True)
    p.add_argument("--output", default="corr_out.h5")
    p.add_argument("--nupchan", type=int, default=2)
    p.add_argument("--gulp", type=int, default=480)
    p.add_argument("--start-freq", type=int, default=0)
    p.add_argument("--end-freq", type=int, default=192)
    p.add_argument("--nframe-per-integration", type=int, default=120000)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the gulps are computed")
    return p


class Replay:
    """The replay of one dump: the header, the integrations of
    :func:`.offline.upchan_imaging_run` and their fine-channel labels."""

    def __init__(self, args):
        src = TriggerFileSource(args.datain)
        hdr, data = src.read()
        self.ninput = hdr["nstand"] * hdr.get("npol", 2)
        packed = data.reshape(hdr["ntime"], hdr["nchan"], hdr["nstand"],
                              hdr.get("npol", 2))
        self.out = offline.upchan_imaging_run(
            packed, nupchan=args.nupchan,
            chan_range=(args.start_freq, args.end_freq),
            nframe_per_integration=args.nframe_per_integration,
            gulp_ntime=args.gulp, device=args.device)
        chan_bw = hdr.get("bw_hz", 1.0) / max(hdr["nchan"], 1)
        fine_bw = chan_bw / args.nupchan
        # fine channel k at sfreq + k * fine_bw, as the JAX CLI labels it
        # (upchan_bf's labels sit half a coarse channel lower; ROADMAP
        # queue 3)
        self.freqs = (hdr.get("sfreq", 0.0)
                      + np.arange(args.start_freq, args.end_freq) * fine_bw)


def write(args, r: Replay) -> None:
    """The HDF5 file of the run (``h5py`` imported by the writer)."""
    w = VisibilityHDF5Writer(args.output, freqs_hz=r.freqs,
                             ninput=r.ninput)
    for i, vis in enumerate(r.out):
        w.append(vis.astype(np.complex64), float(i))
    w.close()
    print(f"wrote {args.output} ({len(r.out)} integrations, "
          f"{args.end_freq - args.start_freq} fine channels)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if no_card(args.device):
        return 2
    write(args, Replay(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
