"""Where the two gulp correlators' time goes: ``csrc/corr_triu.cu`` (fused
unpack per tile pair) and ``csrc/corr_rows.cu`` (row tile resident).

    python -m caltech_bifrost_dsp_tpu_torch.scripts.probe_corr_gulp

Builds variants of each source with nvcc (a copy with a few lines
replaced: the MMAs, the unpack into planes or the fetch of packed bytes
skipped, other chunk and segment lengths, and for ``corr_rows.cu`` the grid
launched row tile fastest instead of heaviest row first), launches each
variant's launcher on the same random block of 704 inputs x 192 channels x
2400 spectra (tci), in one call and in five 480-spectra gulps, and prints
CUDA-event times.
The variants that skip work compute wrong visibilities on purpose; nothing
else uses them.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys

import torch

from ..ops.correlate import chan_major, zero_vis
from ..ops.kernels import _build

SKIP_MMA = [("mma_kstep<", "if (0) mma_kstep<")]
SKIP_UNPACK = [("unpack(0);", "if (0) unpack(0);"),
               ("unpack(k + 1);", "if (0) unpack(k + 1);")]
SKIP_FETCH = [("fetch(k);", "if (0) fetch(k);"),
              ("fetch(k + NSLOT);", "if (0) fetch(k + NSLOT);")]
#: name -> (sources it applies to, text replacements); each old text must
#: be in the source
VARIANTS = {
    "as built": (("corr_triu", "corr_rows"), []),
    "no MMA (fetch and unpack only)": (("corr_triu", "corr_rows"), SKIP_MMA),
    "no unpack (fetch and MMA on stale planes)": (
        ("corr_triu", "corr_rows"), SKIP_UNPACK),
    "no fetch (unpack of stale bytes and MMA)": (
        ("corr_triu", "corr_rows"), SKIP_FETCH),
    "32-sample chunks": (("corr_triu", "corr_rows"), [
        ("constexpr int TCHUNK = 64;", "constexpr int TCHUNK = 32;")]),
    "grid row tile fastest": (("corr_rows",), [
        ("const dim3 grid(nchan, ntile);", "const dim3 grid(ntile, nchan);"),
        ("const int c = blockIdx.x;\n    const int ti = blockIdx.y;",
         "const int c = blockIdx.y;\n    const int ti = blockIdx.x;")]),
    # a condition the compiler cannot decide, so the MMAs are kept
    "no stores of the results": (("corr_triu", "corr_rows"), [
        ("store_piece(", "if (ninput < 0) store_piece(")]),
    "no diagonal MMAs": (("corr_rows",), [
        ("mma_kstep<NEG_A_ALU>(", "if (0) mma_kstep<NEG_A_ALU>(")]),
}


def _variant_source(stem: str, edits: list) -> str:
    src = (_build.CSRC / f"{stem}.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{stem}.cu no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict:
    """{(stem, variant name): loaded library}, all built at once."""
    work = _build.BUILD_DIR / "probe_corr_gulp"
    work.mkdir(parents=True, exist_ok=True)
    for header in _build._headers():
        shutil.copy(header, work / header.name)
    procs = {}
    for k, (name, (stems, edits)) in enumerate(VARIANTS.items()):
        for stem in stems:
            cu = work / f"{stem}_v{k}.cu"
            cu.write_text(_variant_source(stem, edits))
            so = cu.with_suffix(".so")
            procs[stem, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o",
                 str(so), str(cu)]))
    libs = {}
    for key, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for variant {key!r}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_corr_gulp: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ntime, nchan, ni, gulp = 2400, 192, 704, 480
    g = torch.Generator(device=dev).manual_seed(7)
    packed = torch.randint(0, 256, (ntime, nchan, ni), generator=g,
                           device=dev, dtype=torch.uint8)
    # the window in one call, and gulp by gulp as the schedules run calls it
    blocks = {"one call": [chan_major(packed, "tci")],
              f"{ntime // gulp} calls of {gulp}": [
                  chan_major(packed[t:t + gulp], "tci")
                  for t in range(0, ntime, gulp)]}
    out = zero_vis(nchan, ni, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for (stem, name), lib in build_variants().items():
        fn = getattr(lib, f"cbd_{stem}")
        fn.argtypes = _build.SIGNATURES[f"cbd_{stem}"]
        fn.restype = ctypes.c_int
        times = []
        for xcs in blocks.values():
            def call():
                for xc in xcs:
                    rc = fn(xc.data_ptr(), xc.stride(0), xc.stride(1), nchan,
                            xc.shape[1], ni, out.real.data_ptr(),
                            out.imag.data_ptr(), stream)
                    if rc != 0:
                        raise RuntimeError(f"{stem} {name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            reps = 10
            start.record()
            for _ in range(reps):
                call()
            end.record()
            end.synchronize()
            times.append(f"{start.elapsed_time(end) / reps:.3f}")
        print(f"{stem} {name}: ms per {ntime}-spectra window at {ni} inputs "
              f"x {nchan} channels: " + ", ".join(
                  f"{t} ({how})" for t, how in zip(times, blocks)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
