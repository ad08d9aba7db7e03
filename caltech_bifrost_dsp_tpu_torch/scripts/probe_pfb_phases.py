"""Where the pipeline-width channelizers' time goes: each kernel as built
and with one of its phases cut.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_pfb_phases

Builds variants of ``csrc/pfb_quantize.cu`` (the direct kernel: without
its FIR phase, without its MMA loop) and of ``csrc/pfb_fft.cu`` (the FFT
kernel: without its FIR phase, without its stage-1 lane DFTs, without its
stage-2 jobs) with nvcc, each a copy of the source in which a loop is cut
to zero trips by a macro, launches ``cbd_pfb_direct`` and ``cbd_pfb_fft``
of each at 704 inputs x 192 channels x 2400 spectra of int8 ADC and prints
CUDA-event times.  The cut variants compute wrong bytes on purpose;
nothing else uses them.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import pfb, pfb_fused
from ..ops.kernels import _build

#: source, launcher, {variant: macro values}, {text: text with the macros}
KERNELS = {
    "direct": ("pfb_quantize.cu", "cbd_pfb_direct",
               {"as built": (1, 1), "no FIR phase": (0, 1),
                "no MMA loop": (1, 0)},
               {"for (int n = tid / D_TI; n <= nchan; n += THREADS / D_TI) {":
                "for (int n = tid / D_TI; n <= (PROBE_0 ? nchan : -1); "
                "n += THREADS / D_TI) {",
                "const int nslab = kpad / D_KS;":
                "const int nslab = PROBE_1 ? kpad / D_KS : 0;"}),
    "fft": ("pfb_fft.cu", "cbd_pfb_fft",
            {"as built": (1, 1, 1), "no FIR phase": (0, 1, 1),
             "no stage-1 DFT": (1, 0, 1), "no stage 2": (1, 1, 0)},
            {"for (int g = 0; g < M / 4; ++g) {":
             "for (int g = 0; g < (PROBE_0 ? M / 4 : 0); ++g) {",
             "            cdft<H>(z);": "            if (PROBE_1) cdft<H>(z);",
             "for (int t = 0; t < NJOB; ++t) {":
             "for (int t = 0; t < (PROBE_2 ? NJOB : 0); ++t) {"}),
}


def build_variants(kernel: str) -> dict:
    source, _, variants, cuts = KERNELS[kernel]
    src = (_build.CSRC / source).read_text()
    for text, cut in cuts.items():
        if text not in src:
            raise RuntimeError(f"{source} no longer has the probed loops")
        src = src.replace(text, cut)
    work = _build.BUILD_DIR / "probe_pfb_phases"
    work.mkdir(parents=True, exist_ok=True)
    (work / f"{kernel}.cu").write_text(src)
    procs = {}
    for name, flags in variants.items():
        so = work / (kernel + "".join(map(str, flags)) + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared",
             *(f"-DPROBE_{i}={v}" for i, v in enumerate(flags)), "-o",
             str(so), str(work / f"{kernel}.cu")]))
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
    tw = pfb_fused._fft_twiddles(nchan, str(dev))
    scale = torch.full((nchan,), 0.01, device=dev)
    out = torch.empty((ni, nspec, nchan), dtype=torch.uint8, device=dev)
    head = (adc.data_ptr(), adc.stride(0), adc.stride(1), 1, ni, nspec)
    args = {"direct": (*head, nchan, ntap, w.data_ptr(), table.data_ptr(),
                       table.shape[1] * pfb_fused.DIRECT_KS,
                       table.shape[0] * pfb_fused.DIRECT_CPASS,
                       scale.data_ptr(), 0, out.data_ptr()),
            "fft": (*head, nchan, ntap, w.data_ptr(), tw.data_ptr(),
                    scale.data_ptr(), out.data_ptr())}
    for kernel, (_, launcher, _, _) in KERNELS.items():
        for name, lib in build_variants(kernel).items():
            fn = getattr(lib, launcher)
            fn.argtypes = _build.SIGNATURES[launcher]
            fn.restype = ctypes.c_int

            def run():
                rc = fn(*args[kernel],
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{launcher}: CUDA error {rc}")

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run()
            end.record()
            end.synchronize()
            print(f"{launcher}, {name}: "
                  f"{start.elapsed_time(end) / 5:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
