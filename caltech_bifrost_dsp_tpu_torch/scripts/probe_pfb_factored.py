"""Where the factored channelizer's time goes: the FIR-rows kernel with its
float32 scratch, and the DFT kernel's two tensor-core stages.

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_pfb_factored

Builds variants of ``csrc/pfb_quantize.cu`` with nvcc (a copy of the source
in which a launch is skipped or a stage's k loop is cut to zero trips by a
macro), launches ``cbd_pfb_factored`` of each at 704 inputs x 4096 channels
x 240 spectra of int8 ADC and prints CUDA-event times.  The variants
compute wrong bytes on purpose; nothing else uses them.  Needs a CUDA
device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import pfb, pfb_fused
from ..ops.kernels import _build

FIR_LAUNCH = "pfb_fir_rows16_kernel<FAST><<<grid1, THREADS, 0, stream>>>("
DFT_LAUNCH = "kernel<<<dim3(nsc, ninput), THREADS, smem, stream>>>("
STAGE1_LOOP = "for (int ks = 0; ks < L2 / 8; ++ks) {"
STAGE2_LOOP = "for (int ks = 0; ks < L1 / 8; ++ks) {"
#: name -> (FIR kernel, DFT kernel, stage 1 loop, stage 2 loop)
VARIANTS = {
    "as built": (1, 1, 1, 1),
    "FIR-rows kernel and scratch write only": (1, 0, 1, 1),
    "DFT kernel only (scratch read, both stages, bytes out)": (0, 1, 1, 1),
    "DFT kernel without stage 1": (0, 1, 0, 1),
    "DFT kernel without stage 2": (0, 1, 1, 0),
    "DFT kernel without either stage (copies, twiddle, pack)": (0, 1, 0, 0),
}


def build_variants() -> dict:
    src = (_build.CSRC / "pfb_quantize.cu").read_text()
    for text in (FIR_LAUNCH, DFT_LAUNCH, STAGE1_LOOP, STAGE2_LOOP):
        if src.count(text) != 1:
            raise RuntimeError("pfb_quantize.cu no longer has the probed "
                               f"line {text!r} once")
    src = src.replace(FIR_LAUNCH, "if (PROBE_FIR) " + FIR_LAUNCH)
    src = src.replace(DFT_LAUNCH, "if (PROBE_DFT) " + DFT_LAUNCH)
    src = src.replace(STAGE1_LOOP, STAGE1_LOOP.replace(
        "ks < L2 / 8", "ks < (PROBE_S1 ? L2 / 8 : 0)"))
    src = src.replace(STAGE2_LOOP, STAGE2_LOOP.replace(
        "ks < L1 / 8", "ks < (PROBE_S2 ? L1 / 8 : 0)"))
    work = _build.BUILD_DIR / "probe_pfb_factored"
    work.mkdir(parents=True, exist_ok=True)
    (work / "pfb.cu").write_text(src)
    procs = {}
    for name, flags in VARIANTS.items():
        so = work / ("v" + "".join(map(str, flags)) + ".so")
        defs = [f"-DPROBE_{key}={val}" for key, val in
                zip(("FIR", "DFT", "S1", "S2"), flags)]
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", *defs,
             "-o", str(so), str(work / "pfb.cu")]))
    libs = {}
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {name!r}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_pfb_factored: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    nchan, ntap, nspec, ni = 4096, 4, 240, 704
    L = 2 * nchan
    L1, L2 = pfb._dft_factors(L)
    g = torch.Generator(device=dev).manual_seed(5)
    adc = torch.randint(-90, 91, ((nspec + ntap - 1) * L, ni), generator=g,
                        device=dev, dtype=torch.int8)
    w = torch.from_numpy(pfb.pfb_window(nchan, ntap)).to(dev)
    inner, tw, outer = pfb_fused._factored_tables(nchan, False, str(dev))
    scale = torch.full((nchan,), 0.01, device=dev)
    out = torch.empty((ni, nspec, nchan), dtype=torch.uint8, device=dev)
    chunk = pfb_fused.factored_chunk(ni, nspec, L)
    scratch = torch.zeros((ni, chunk, L), dtype=torch.float32, device=dev)
    for name, lib in build_variants().items():
        fn = lib.cbd_pfb_factored
        fn.argtypes = _build.SIGNATURES["cbd_pfb_factored"]
        fn.restype = ctypes.c_int

        def run():
            rc = fn(adc.data_ptr(), adc.stride(0), adc.stride(1), 1, ni,
                    nspec, nchan, ntap, L1, L2, w.data_ptr(),
                    inner.data_ptr(), tw.data_ptr(), outer.data_ptr(),
                    scale.data_ptr(), 0, scratch.data_ptr(), chunk,
                    out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"cbd_pfb_factored: CUDA error {rc}")

        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            run()
        end.record()
        end.synchronize()
        print(f"cbd_pfb_factored, {name}: "
              f"{start.elapsed_time(end) / 3:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
