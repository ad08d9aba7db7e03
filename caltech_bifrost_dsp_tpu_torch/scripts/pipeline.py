"""X-engine pipeline CLI for the PyTorch port.

The analog of ``caltech_bifrost_dsp_tpu/scripts/pipeline.py`` (the
reference's ``lwa352-pipeline.py`` operator entry point): assembles one
:class:`..runtime.driver.XEnginePipeline` (synthetic source -> fused step
on the card -> packet sinks) from the same flags, wires the in-process
control store and the monitor bridge, installs signal handlers and runs.

``--testdatacorr`` gates every slow dump by exact equality (exit 1 on a
mismatch), ``--testcorr`` compares every fast dump with a numpy
correlator, ``--save-slow`` keeps the last slow dump as an ``.npz`` file.
``--fx`` feeds raw ADC samples (noise, or a tone with ``--fx-tone-chan``)
through the PFB channelizer in front of the X/B step.  ``--device cpu``
runs the plain versions of the kernels.  ``--mesh TIMExCHAN`` runs the
sharded programs of ``parallel/mesh.py``: on the host's CUDA devices, one
per shard (fewer devices than shards: exit 2 with the count, nothing is
placed silently), or with ``--device cpu`` with every shard on the CPU.
Not ported yet, and refused with exit code 2: ``--xdp``, UDP capture
(running without ``--fakesource``), ``--etcdhost``, ``--bufgbytes`` > 0
and ``--dump-direct``.

Examples::

  # golden-vector verification run on the GPU, COR packets to a receiver
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --testdatain in.dat --testdatacorr corr.dat --ngulp 2000 \\
      --corr-dest 10.1.1.1:10001 --cor-fmt

  # small run on the CPU with the subselection sent over UDP
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --nstand 16 --nchan 16 --nbeam 4 --ntime_gulp 48 --acc_len 240 \\
      --acc_len_slow 480 --ngulp 20 --device cpu \\
      --subsel-dest 127.0.0.1:19734

  # FX mode: a tone in channel 9 through the channelizer, on the CPU
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --fx --fx-tone-chan 9 --nstand 8 --nchan 32 --ntime_gulp 48 \\
      --acc_len 96 --acc_len_slow 192 --nbeam 4 --ngulp 8 --device cpu \\
      --save-slow slow.npz

  # the sharded programs on a 2x4 mesh whose shards share the CPU
  python -m caltech_bifrost_dsp_tpu_torch.scripts.pipeline --fakesource \\
      --nstand 16 --nchan 16 --nbeam 4 --ntime_gulp 48 --acc_len 240 \\
      --acc_len_slow 480 --ngulp 20 --device cpu --mesh 2x4 --testcorr
"""

from __future__ import annotations

import argparse
import logging
import logging.handlers
import signal
import sys
import time

import numpy as np
import torch

from ..config import LWA352, TPU_ENGINES, XEngineConfig
from ..control.command import CommandBlock
from ..control.monitor import MonitorBridge
from ..control.store import connect
from ..io import sink
from ..io.source import ADCSource, SyntheticSource
from ..parallel.mesh import make_mesh
from ..runtime.driver import XEnginePipeline


def setup_logging(logfile: str | None, verbosity: int) -> logging.Logger:
    """UTC-formatted logging (reference: lwa352-pipeline.py:86-99)."""
    log = logging.getLogger(__name__)
    fmt = logging.Formatter(
        "%(asctime)s [%(levelname)-8s] %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    fmt.converter = time.gmtime
    handler = (logging.StreamHandler(sys.stdout) if logfile is None
               else logging.handlers.TimedRotatingFileHandler(
                   logfile, when="D", backupCount=21, utc=True))
    handler.setFormatter(fmt)
    log.handlers[:] = [handler]
    log.setLevel(logging.DEBUG if verbosity > 0 else
                 logging.INFO if verbosity == 0 else logging.WARNING)
    return log


def _dest(s: str):
    ip, _, port = s.partition(":")
    return ip, int(port or 10000)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="LWA-352 X-engine pipeline (PyTorch + CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("-P", "--pipelineid", type=int, default=0)
    p.add_argument("-c", "--nchan", type=int, default=LWA352.nchan)
    p.add_argument("--nstand", type=int, default=LWA352.nstand)
    p.add_argument("--nbeam", type=int, default=LWA352.nbeam)
    p.add_argument("-a", "--acc_len", type=int, default=LWA352.acc_len)
    p.add_argument("--acc_len_slow", type=int,
                   default=LWA352.acc_len_slow)
    p.add_argument("-t", "--ntime_gulp", type=int,
                   default=LWA352.ntime_gulp)
    p.add_argument("--autostartat", type=int, default=0,
                   help="-1 starts on the next boundary")
    p.add_argument("--fakesource", action="store_true",
                   help="use the synthetic source (required: UDP capture "
                        "is not ported)")
    p.add_argument("--testdatain", type=str, default=None,
                   help="golden input .dat file to loop")
    p.add_argument("--testdatacorr", type=str, default=None,
                   help="golden correlation .dat for the equality gate")
    p.add_argument("--testdatacorr_acc_len", type=int, default=2400)
    p.add_argument("--target_throughput", type=float, default=1000.0,
                   help="synthetic source rate cap, Gb/s")
    p.add_argument("--corr-dest", type=str, default=None,
                   metavar="IP:PORT")
    p.add_argument("--subsel-dest", type=str, default=None)
    p.add_argument("--pbeam-dest", type=str, default=None,
                   help="beam b goes to PORT + b")
    p.add_argument("--ibeam-dest", type=str, default=None)
    p.add_argument("--max_mbps", type=int, default=1500)
    p.add_argument("--cor-fmt", action="store_true",
                   help="emit the production LWA-SV COR (Mark5C) wire "
                        "format on the full/partial visibility outputs")
    p.add_argument("--dump-direct", action="store_true",
                   help="not ported yet")
    p.add_argument("--bufgbytes", type=float, default=0.0,
                   help="deep trigger-history buffer in GB (not ported "
                        "yet: only 0)")
    p.add_argument("--ngulp", type=int, default=0,
                   help="stop after N gulps (0 = run forever)")
    p.add_argument("--testcorr", action="store_true",
                   help="run a (slow) numpy correlator alongside and "
                        "compare every fast dump exactly")
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
    p.add_argument("--corr-engine", type=str, default="auto",
                   choices=["auto", "xla", "pallas_triu", "pallas_blk"],
                   help="correlator engine: pallas_triu runs the gulp "
                        "correlator plus in-place accumulator adds, the "
                        "others the correlator with the algebra fused in; "
                        "'auto' = config.TPU_ENGINES")
    p.add_argument("--bf-engine", type=str, default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="beamformer engine name (both run the fused "
                        "beamformer kernel); 'auto' = config.TPU_ENGINES")
    p.add_argument("--subsel-engine", type=str, default="auto",
                   choices=["auto", "bands", "xla", "pallas"],
                   help="baseline-subselection engine name (all run the "
                        "one gather kernel); 'auto' = config.TPU_ENGINES")
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
                        "--quant-scale; runtime-updatable via the FEngine "
                        "'eq_gains' command key)")
    p.add_argument("--fx-tone-chan", type=int, default=-1,
                   help="FX fakesource: put a test tone in this channel")
    p.add_argument("--adc-amplitude", type=float, default=None,
                   help="FX fakesource amplitude in ADC units (default 4.0 "
                        "for float32, 32.0 for int8)")
    p.add_argument("--mesh", type=str, default=None, metavar="TIMExCHAN",
                   help="run the step sharded over a (time x chan) device "
                        "mesh, e.g. 2x4: one CUDA device per shard, or "
                        "every shard on the CPU with --device cpu")
    p.add_argument("--xdp", type=str, default=None, metavar="IFNAME",
                   help="not ported yet")
    p.add_argument("--etcdhost", type=str, default=None,
                   help="not ported yet (the in-process store is used)")
    p.add_argument("-l", "--logfile", type=str, default=None)
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
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


class SlowDumpKeeper:
    """A full-correlation sink that keeps the last slow dump's planes."""

    checkfile = None

    def __init__(self):
        self.planes = None

    def send_matrix_planes(self, vis_re, vis_im, *args) -> int:
        self.planes = (vis_re, vis_im)
        return 0


def refuse_unported(parser: argparse.ArgumentParser, args) -> None:
    """Exit 2 on every flag whose machinery is not ported yet."""
    unported = [("--xdp", args.xdp),
                ("--etcdhost", args.etcdhost),
                ("--bufgbytes > 0", args.bufgbytes > 0),
                ("--dump-direct", args.dump_direct),
                ("UDP capture (no --fakesource)", not args.fakesource)]
    for flag, given in unported:
        if given:
            parser.error(f"{flag} is not ported yet")
    if args.fx and (args.testdatain or args.testdatacorr):
        parser.error("--fx takes raw ADC samples; the golden test vectors "
                     "are packed post-F input")


def build_mesh(parser: argparse.ArgumentParser, args):
    """``--mesh TIMExCHAN`` -> Mesh (None without the flag).  Exit 2 when
    the host has fewer CUDA devices than the mesh has shards."""
    if not args.mesh:
        return None
    n_time, _, n_chan = args.mesh.partition("x")
    try:
        n_time, n_chan = int(n_time), int(n_chan)
    except ValueError:
        parser.error(f"--mesh takes TIMExCHAN, got {args.mesh!r}")
    if args.device == "cpu":
        return make_mesh(n_time, n_chan, devices=["cpu"] * (n_time * n_chan))
    have = torch.cuda.device_count()
    if have < n_time * n_chan:
        parser.error(f"--mesh {args.mesh} needs {n_time * n_chan} CUDA "
                     f"devices, this host has {have}")
    return make_mesh(n_time, n_chan)


def build_pipeline(args, mesh=None
                   ) -> tuple[XEnginePipeline, SlowDumpKeeper | None]:
    engines = dict(TPU_ENGINES)
    for key in ("corr_engine", "bf_engine", "subsel_engine"):
        if getattr(args, key) != "auto":
            engines[key] = getattr(args, key)
    cfg = XEngineConfig(
        nstand=args.nstand, nchan=args.nchan, nbeam=args.nbeam,
        ntime_gulp=args.ntime_gulp, acc_len=args.acc_len,
        acc_len_slow=args.acc_len_slow, pipeline_id=args.pipelineid,
        pfb_fft_impl=args.pfb_impl, pfb_precision=args.pfb_precision,
        adc_dtype=args.adc_dtype, **engines)
    CommandBlock.set_id(args.pipelineid)
    store = connect(None)
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
        src = SyntheticSource(cfg, mode="testfile", testfile=args.testdatain,
                              target_throughput_gbps=args.target_throughput)
    else:
        src = SyntheticSource(cfg, mode="ramp",
                              target_throughput_gbps=args.target_throughput)

    corr_outputs = []
    if args.corr_dest or args.testdatacorr:
        send = (sink.UdpSender(*_dest(args.corr_dest))
                if args.corr_dest else None)
        corr_outputs.append(sink.CorrFullOutput(
            cfg, send=send, max_mbps=args.max_mbps,
            checkfile=args.testdatacorr,
            checkfile_acc_len=args.testdatacorr_acc_len,
            use_cor_fmt=args.cor_fmt))
    keeper = None
    if args.save_slow:
        keeper = SlowDumpKeeper()
        corr_outputs.append(keeper)
    subsel_outputs = []
    if args.subsel_dest:
        subsel_outputs.append(sink.CorrPartOutput(
            cfg, send=sink.UdpSender(*_dest(args.subsel_dest)),
            max_mbps=args.max_mbps, use_cor_fmt=args.cor_fmt))
    pbeam_outputs = []
    if args.pbeam_dest:
        ip, port = _dest(args.pbeam_dest)
        pbeam_outputs.append(sink.PBeamOutput(
            cfg, senders={b: sink.UdpSender(ip, port + b)
                          for b in range(cfg.nbeam // 2)},
            pipeline_idx=args.pipelineid + 1))
    ibeam_outputs = []
    if args.ibeam_dest:
        ibeam_outputs.append(sink.IBeamOutput(
            cfg, send=sink.UdpSender(*_dest(args.ibeam_dest)),
            pipeline_idx=args.pipelineid + 1))

    pipe = XEnginePipeline(
        cfg, src, store=store, corr_outputs=corr_outputs,
        subsel_outputs=subsel_outputs, pbeam_outputs=pbeam_outputs,
        ibeam_outputs=ibeam_outputs, autostartat=args.autostartat,
        sync_time=int(time.time()), selftest=args.testcorr,
        fx_mode=args.fx, quant_scale=args.quant_scale,
        eq_gains=load_eq_gains(args.eq_gains, cfg.nchan), mesh=mesh,
        device=args.device)
    pipe.monitor_bridge = MonitorBridge(store, pipeline_id=args.pipelineid)
    return pipe, keeper


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    refuse_unported(parser, args)
    mesh = build_mesh(parser, args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda but no CUDA device is available "
              "(use --device cpu for the plain reference path)",
              file=sys.stderr)
        return 2
    log = setup_logging(args.logfile, args.verbose - args.quiet)
    pipe, keeper = build_pipeline(args, mesh)

    def _shutdown(signum, frame):
        log.info("signal %d: shutting down", signum)
        pipe.shutdown()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, _shutdown)
    log.info("pipeline %d starting (nchan=%d nstand=%d, %s on %s)",
             args.pipelineid, args.nchan, args.nstand,
             pipe.cfg.corr_engine, args.device)
    pipe.monitor_bridge.start()
    t0 = time.perf_counter()
    try:
        pipe.run(args.ngulp)
    finally:
        pipe.monitor_bridge.stop()
    if keeper is not None and keeper.planes is not None:
        np.savez(args.save_slow, real=keeper.planes[0],
                 imag=keeper.planes[1])
    print(f"{pipe.ndump_fast} fast dumps, {pipe.ndump_slow} slow dumps in "
          f"{time.perf_counter() - t0:.3f} s on {args.device}")
    rc = 0
    for out in pipe.corr_outputs:
        if out.checkfile:
            print(f"golden check: {out.check_count - out.check_failures}"
                  f"/{out.check_count} passed")
            rc = rc or int(bool(out.check_failures))
    if pipe.selftest:
        print(f"selftest: {pipe.selftest_count - pipe.selftest_failures}"
              f"/{pipe.selftest_count} passed")
        rc = rc or int(bool(pipe.selftest_failures))
    return rc


if __name__ == "__main__":
    sys.exit(main())
