"""Where the direct channelizer's time goes: the kernel as built, without
its FIR phase and without its MMA loop.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_pfb_phases

Builds three variants of ``csrc/pfb_quantize.cu`` with nvcc (a copy of the
source in which the FIR loop or the slab loop is cut to zero trips by a
macro), launches ``cbd_pfb_direct`` of each at 704 inputs x 192 channels x
2400 spectra of int8 ADC and prints CUDA-event times.  The variants compute
wrong bytes on purpose; nothing else uses them.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import pfb, pfb_fused
from ..ops.kernels import _build

FIR_LOOP = "for (int n = tid / D_TI; n <= nchan; n += THREADS / D_TI) {"
SLAB_COUNT = "const int nslab = kpad / D_KS;"
VARIANTS = {"as built": (1, 1), "no FIR phase": (0, 1), "no MMA loop": (1, 0)}


def build_variants() -> dict:
    src = (_build.CSRC / "pfb_quantize.cu").read_text()
    if FIR_LOOP not in src or SLAB_COUNT not in src:
        raise RuntimeError("pfb_quantize.cu no longer has the probed loops")
    src = src.replace(FIR_LOOP, FIR_LOOP.replace(
        "n <= nchan", "n <= (PROBE_FIR ? nchan : -1)"))
    src = src.replace(SLAB_COUNT,
                      "const int nslab = PROBE_MMA ? kpad / D_KS : 0;")
    work = _build.BUILD_DIR / "probe_pfb_phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / "pfb.cu").write_text(src)
    procs = {}
    for name, (fir, mma) in VARIANTS.items():
        so = work / f"fir{fir}_mma{mma}.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
             f"-DPROBE_FIR={fir}", f"-DPROBE_MMA={mma}", "-o", str(so),
             str(work / "pfb.cu")]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_pfb_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    nchan, ntap, nspec, ni = 192, 4, 2400, 704
    g = torch.Generator(device=dev).manual_seed(5)
    adc = torch.randint(-90, 91, ((nspec + ntap - 1) * 2 * nchan, ni),
                        generator=g, device=dev, dtype=torch.int8)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    table = pfb_fused._direct_table(nchan, False, str(dev))
    scale = torch.full((nchan,), 0.01, device=dev)
    out = torch.empty((ni, nspec, nchan), dtype=torch.uint8, device=dev)
    for name, lib in build_variants().items():
        fn = lib.cbd_pfb_direct
        fn.argtypes = _build.SIGNATURES["cbd_pfb_direct"]
        fn.restype = ctypes.c_int

        def run():
            rc = fn(adc.data_ptr(), adc.stride(0), adc.stride(1), 1, ni,
                    nspec, nchan, ntap, w.data_ptr(), table.data_ptr(),
                    table.shape[1] * pfb_fused.DIRECT_KS,
                    table.shape[0] * pfb_fused.DIRECT_CPASS,
                    scale.data_ptr(), 0, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"cbd_pfb_direct: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run()
        end.record()
        end.synchronize()
        print(f"cbd_pfb_direct, {name}: {start.elapsed_time(end) / 5:.3f} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
