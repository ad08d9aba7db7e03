"""Offline upchannelizing beamformer CLI (port of
``caltech_bifrost_dsp_tpu/scripts/upchan_bf.py``: the same flags, defaults
and files, plus ``--device``).

Analog of reference: pipeline/scripts/lwa352-upchan-bf.py: replays a
triggered-dump file, upchannelizes 32x, points beams at RA/Dec targets
with geometric + calibration weights, reduces over antennas/pols and
writes accumulated beam powers (or voltages) to HDF5.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.upchan_bf \\
        --datain lwa-dump_0_0.tbf --output beams.h5 \\
        --ra-array 10,20 --dec-array 30,40 [--voltages] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..io.hdf5 import (AccumBeamHDF5Writer, BeamHDF5Writer,
                       FullObservationHDF5Writer)
from ..io.source import TriggerFileSource
from ..models import offline


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Offline upchannelize + beamform",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--datain", required=True,
                   help="triggered-dump .tbf file to replay")
    p.add_argument("--output", default="output.h5")
    p.add_argument("--ra-array", default="0.0",
                   help="comma-separated beam RAs (deg)")
    p.add_argument("--dec-array", default="37.0",
                   help="comma-separated beam Decs (deg)")
    p.add_argument("--nupchan", type=int, default=32)
    p.add_argument("--gulp", type=int, default=480)
    p.add_argument("--cal-file", default=None,
                   help=".npy complex cal gains [nchan_fine, ninput]")
    p.add_argument("--enz-file", default=None,
                   help=".npy [nstand, 3] antenna ENZ positions (m); "
                        "default: a pseudo-random compact layout")
    p.add_argument("--accumulate", action="store_true", default=True)
    p.add_argument("--voltages", dest="accumulate", action="store_false")
    p.add_argument("--full-obs", action="store_true",
                   help="write into a preallocated whole-observation "
                        "file (HDF5FullSaveBlock analog; --output is "
                        "then the path PREFIX, RA/Dec are appended)")
    p.add_argument("--obs-nsamples", type=int, default=0,
                   help="total time samples to preallocate with "
                        "--full-obs (default: this run's length)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the gulps are computed")
    return p


class Replay:
    """What the replay of one dump gives the writers: the header values,
    the pointings, the fine-channel frequencies and the per-gulp outputs
    of :func:`.offline.upchan_beamform_run`."""

    def __init__(self, args):
        src = TriggerFileSource(args.datain)
        hdr, data = src.read()
        nstand = hdr["nstand"]
        npol = hdr.get("npol", 2)
        packed = data.reshape(hdr["ntime"], hdr["nchan"], nstand, npol)
        self.ra = [float(x) for x in args.ra_array.split(",")]
        self.dec = [float(x) for x in args.dec_array.split(",")]
        if args.full_obs and len(self.ra) > 1:
            raise SystemExit(
                "--full-obs writes the reference's single-beam "
                "observation file (HDF5FullSaveBlock assumes nbeam=1); "
                "pass one RA/Dec, or drop --full-obs for the per-beam "
                "dynamic writer")
        if args.enz_file:
            enz = np.load(args.enz_file)
        else:
            enz = np.random.RandomState(0).standard_normal([nstand, 3]) * 100
        cal = np.load(args.cal_file) if args.cal_file else None
        self.cfg = offline.OfflineBeamConfig(
            nbeam=len(self.ra), ra_deg=self.ra, dec_deg=self.dec,
            enz_positions=enz, nupchan=args.nupchan, cal_gains=cal)
        self.sfreq = hdr.get("sfreq", 0.0)
        self.chan_bw = hdr.get("bw_hz", 1.0) / max(hdr["nchan"], 1)
        self.t_unix = hdr.get("sync_time", 0.0)
        self.freqs, self.outs = offline.upchan_beamform_run(
            packed, self.cfg, self.sfreq, self.chan_bw, t_unix=self.t_unix,
            gulp_ntime=args.gulp, accumulate=args.accumulate,
            device=args.device)
        # each output row accumulates one gulp of coarse spectra; the
        # coarse spectrum period is 1/chan_bw, so the real row cadence is
        # gulp/chan_bw seconds, NOT 1 s (timestamps and tInt-style attrs
        # must reflect the actual accumulation span)
        self.tstep_s = args.gulp / self.chan_bw if self.chan_bw > 0 else 1.0


def write(args, r: Replay) -> None:
    """The HDF5 file of the run (``h5py`` imported by the writer)."""
    freqs, outs, ra, dec = r.freqs, r.outs, r.ra, r.dec
    if args.full_obs:
        fstep = r.chan_bw / args.nupchan
        w = FullObservationHDF5Writer(
            args.output.removesuffix(".h5").removesuffix(".hdf5"),
            ra=ra[0], dec=dec[0], tstart_unix=r.t_unix, tstep_s=r.tstep_s,
            total_nsamples=args.obs_nsamples or len(outs),
            sfreq_hz=float(freqs[0]), fstep_hz=fstep,
            total_nfreq=len(freqs))
        for i, powers in enumerate(outs):
            # beam 0 intensity row per accumulated spectrum
            w.write(powers[:1].astype(np.float32), r.t_unix + i * r.tstep_s,
                    float(freqs[0]))
        w.close()
        print(f"wrote {w.filename} ({len(outs)} rows, "
              f"{len(freqs)} fine channels)")
        return
    if args.accumulate:
        w = AccumBeamHDF5Writer(args.output, nbeam=len(ra), freqs_hz=freqs)
        for i, powers in enumerate(outs):
            w.append(powers.astype(np.float32), r.t_unix + i * r.tstep_s)
        w.close()
    else:
        w = BeamHDF5Writer(args.output, nbeam=len(ra), freqs_hz=freqs)
        for beams in outs:
            w.append(beams)
        w.close()
    print(f"wrote {args.output} ({len(outs)} gulps, {len(ra)} beams, "
          f"{len(freqs)} fine channels)")


def no_card(device: str) -> bool:
    """True, with the error printed, where ``--device cuda`` finds no
    card: the CLIs never carry on on the CPU unasked."""
    if device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu)", file=sys.stderr)
        return True
    return False


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if no_card(args.device):
        return 2
    write(args, Replay(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
