"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into ONE shared library with plain
``extern "C"`` launchers, loaded with ``ctypes``: one ``nvcc -c`` per
source, all started together, then one link.  The library lands in
``caltech_bifrost_dsp_tpu_torch/_build/`` under a name that carries the
hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  Nothing is built at import; a failed build
raises and nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: argtypes of every launcher; each returns a cudaError_t as int
SIGNATURES = {
    "cbd_corr_acc": (_P, _L, _L, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P),
    "cbd_corr_acc_cached": (_P, _L, _L, _I, _I, _I, _P, _L, _P, _P, _P, _P,
                            _I, _I, _I, _P),
    "cbd_corr_blk": (_P, _L, _L, _I, _I, _I, _P, _L, _P, _P, _P),
    "cbd_corr_rows": (_P, _L, _L, _I, _I, _I, _P, _P, _P),
    "cbd_corr_triu": (_P, _L, _L, _I, _I, _I, _P, _P, _P),
    "cbd_beamform_products": (_P, _L, _L, _I, _I, _I, _P, _P, _I, _I, _P,
                              _P, _P),
    "cbd_subsel_gather": (_P, _P, _I, _I, _P, _I, _I, _P, _P, _P),
    "cbd_pfb_direct": (_P, _L, _L, _I, _I, _I, _I, _I, _P, _P, _I, _I, _P,
                       _I, _P, _P),
    "cbd_pfb_factored": (_P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                         _P, _P, _P, _I, _P, _I, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return nvcc


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    The compilers' reports (``-Xptxas -v``: registers, shared memory,
    spills) are kept beside the library as ``<name>.log``."""
    so = BUILD_DIR / f"libcbd_kernels_{source_hash()}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [proc.communicate()[0] for proc in procs]
    failed = [src.name for src, proc in zip(_sources(), procs)
              if proc.returncode != 0]
    if not failed:
        tmp = so.with_name(f"{so.name}.{tag}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append("link")
    so.with_suffix(".log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n"
                           + "\n".join(logs))
    os.replace(tmp, so)
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cbd_error_string.argtypes = (ctypes.c_int,)
    lib.cbd_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` on ``device``'s current stream (appended as
    the last argument) and raise if it reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.cbd_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def device_of(*tensors: torch.Tensor) -> torch.device:
    """The one device all ``tensors`` lie on, "cpu" or a CUDA device;
    raise for mixed devices or any other device type."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and "
                             f"{t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev


def require_contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
