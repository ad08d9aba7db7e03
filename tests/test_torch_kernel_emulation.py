"""``csrc/corr_acc.cu`` and ``csrc/pfb_quantize.cu`` compiled with g++
against ``tests/cuda_stub/cuda_runtime.h`` and run on CPU arrays through
their ``extern "C"`` launchers (the correlator's three, the direct
channelizer's one), against the plain versions.

The stub runs a block's threads as host threads and supplies the int8
tensor-core instruction lane by lane from the PTX fragment layout, so this
holds the kernel's fragment and lane maps, its staging, its masking of
ragged edges and its epilogue to the plain correlator where no GPU is at
hand.  Shapes are tiny and ragged (inputs not a multiple of the 128-tile,
times not a multiple of the 64-sample chunk or the 32-sample MMA step);
one input is structured (a distinct value per input and per time sample)
so that a wrong map cannot hide in noise, and one is all 0x88 (both nibbles
-8, the widest products).  The direct channelizer (FP64 tensor-core MMA,
folded real DFT) runs at ragged spectra and inputs, one and two channel
passes, int8 and float32 ADC, both precisions, under the packed-byte gate.
Skips without g++.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cb
from caltech_bifrost_dsp_tpu_torch.ops import pfb, pfb_fused
from caltech_bifrost_dsp_tpu_torch.ops.corr_acc import (cache_shape,
                                                        corr_acc_ref,
                                                        unpack_planes_ref)
from caltech_bifrost_dsp_tpu_torch.ops.correlate import Vis
from caltech_bifrost_dsp_tpu_torch.ops.kernels import _build

torch.set_num_threads(1)

STUB = Path(__file__).resolve().with_name("cuda_stub")
LAUNCH = re.compile(r"(\w+(?:<[^<>;()]*>)?)<<<(.*?)>>>\(", re.S)
DYNAMIC = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?"
                     r"(\w+)\s+(\w+)\[\];")


def host_source(text: str) -> str:
    """The kernel source with its launches and its dynamic shared memory
    rewritten for the stub."""
    text = LAUNCH.sub(r"cbd_emu::launcher(\1, \2)(", text)
    return DYNAMIC.sub(r"\1* \2 = static_cast<\1*>("
                       r"cbd_emu::dynamic_shared());", text)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    work = tmp_path_factory.mktemp("emulation")
    srcs = []
    for stem in ("corr_acc", "pfb_quantize"):
        srcs.append(work / f"{stem}.cpp")
        srcs[-1].write_text(host_source(
            (_build.CSRC / f"{stem}.cu").read_text()))
    so = work / "libkernels_host.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{STUB}", "-o", str(so), *map(str, srcs)], check=True)
    lib = ctypes.CDLL(str(so))
    for name in ("cbd_corr_acc", "cbd_corr_acc_cached", "cbd_corr_blk",
                 "cbd_pfb_direct"):
        fn = getattr(lib, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def block(kind: str, ntime: int, nchan: int, ni: int) -> np.ndarray:
    """A packed block [nchan, ntime, ni] (cti)."""
    if kind == "random":
        rng = np.random.RandomState(ntime * 1000 + ni)
        return rng.randint(0, 256, (nchan, ntime, ni)).astype(np.uint8)
    if kind == "widest":
        return np.full((nchan, ntime, ni), 0x88, np.uint8)
    # structured: a distinct byte pattern per input and per time sample
    c, t, i = np.meshgrid(np.arange(nchan), np.arange(ntime), np.arange(ni),
                          indexing="ij")
    return ((i * 7 + t * 13 + c * 29) % 256).astype(np.uint8)


def ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# (ntime, nchan, ninput): one partial tile; two tiles, the second ragged,
# two chunks and a ragged MMA step; one sample; three tiles
SHAPES = [(33, 2, 72), (70, 1, 140), (1, 1, 130), (31, 1, 260)]
FLAGS = [(True, False, False), (False, False, False), (False, True, True),
         (False, True, False), (True, True, False), (True, True, True)]


def run_acc(lib, cached: bool, xc: np.ndarray, planes, flags) -> None:
    nchan, ntime, ni = xc.shape
    args = [ptr(xc), xc.strides[0], xc.strides[1], nchan, ntime, ni]
    if cached:
        scratch = np.full(cache_shape(nchan, ntime, ni), 0x55, np.int32)
        args += [ptr(scratch), scratch.size]
    args += [ptr(p) for p in planes] + [int(f) for f in flags] + [None]
    fn = lib.cbd_corr_acc_cached if cached else lib.cbd_corr_acc
    assert fn(*args) == 0


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kind,ntime,nchan,ni", [
    ("random", *SHAPES[0]), ("structured", *SHAPES[1]),
    ("random", *SHAPES[2]), ("widest", *SHAPES[1]),
    ("structured", *SHAPES[3])])
def test_corr_acc_emulated_matches_plain(lib, cached, kind, ntime, nchan,
                                         ni):
    xc = block(kind, ntime, nchan, ni)
    rng = np.random.RandomState(ni)
    upper = np.triu(np.ones((ni, ni), bool))
    tile = np.arange(ni) // cb.TILE
    below = tile[:, None] > tile[None, :]
    flag_sets = FLAGS if kind == "random" else FLAGS[3:5]
    for flags in flag_sets:
        init = [rng.randint(-2 ** 20, 2 ** 20, (nchan, ni, ni))
                .astype(np.int32) for _ in range(4)]
        want = [torch.from_numpy(p.copy()) for p in init]
        corr_acc_ref(torch.from_numpy(xc), Vis(*want[:2]), Vis(*want[2:]),
                     *flags)
        got = [p.copy() for p in init]
        run_acc(lib, cached, xc, got, flags)
        for g, w, p in zip(got, want, init):
            np.testing.assert_array_equal(g[:, upper], w.numpy()[:, upper])
            # tiles below the diagonal are never written
            np.testing.assert_array_equal(g[:, below], p[:, below])


@pytest.mark.parametrize("kind,ntime,nchan,ni", [
    ("random", *SHAPES[1]), ("structured", *SHAPES[0]),
    ("random", *SHAPES[3]), ("structured", 65, 2, 129)])
def test_corr_blk_emulated_matches_plain(lib, kind, ntime, nchan, ni):
    """The gulp launcher on a strided view (a shard cut out of a larger
    block in chan and time); the scratch comes back as the plain unpack."""
    big = block(kind, ntime + 9, nchan + 2, ni + 12)
    xc = big[1:1 + nchan, 4:4 + ntime, :ni]
    out = [np.zeros((nchan, ni, ni), np.int32) for _ in range(2)]
    scratch = np.full(cache_shape(nchan, ntime, ni), 0x55, np.int32)
    rc = lib.cbd_corr_blk(ptr(xc), xc.strides[0], xc.strides[1], nchan,
                          ntime, ni, ptr(scratch), scratch.size, ptr(out[0]),
                          ptr(out[1]), None)
    assert rc == 0
    dense = torch.from_numpy(np.ascontiguousarray(xc))
    np.testing.assert_array_equal(scratch, unpack_planes_ref(dense).numpy())
    want = cb.corr_blk_ref(dense)
    tile = np.arange(ni) // cb.TILE
    valid = tile[:, None] <= tile[None, :]
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g[:, valid], w.numpy()[:, valid])
        assert not g[:, ~valid].any()


def test_launchers_refuse_a_short_scratch(lib):
    xc = block("random", 8, 1, 16)
    planes = [np.zeros((1, 16, 16), np.int32) for _ in range(4)]
    scratch = np.zeros(cache_shape(1, 8, 16), np.int32)
    args = [ptr(xc), xc.strides[0], xc.strides[1], 1, 8, 16, ptr(scratch),
            scratch.size - 1]
    assert lib.cbd_corr_acc_cached(*args, *(ptr(p) for p in planes), 1, 1, 1,
                                   None) != 0
    assert lib.cbd_corr_blk(*args, ptr(planes[0]), ptr(planes[1]),
                            None) != 0


@pytest.mark.parametrize("nchan,nspec,ninput,dtype,fast,per_chan", [
    (16, 4, 18, "int8", False, False), (16, 5, 3, "float32", False, True),
    (24, 2, 17, "int8", True, False), (200, 2, 5, "int8", False, True),
    (16, 4, 32, "int8", False, False), (24, 5, 16, "int8", True, True)])
def test_pfb_direct_emulated_passes_the_gate(lib, nchan, nspec, ninput, dtype,
                                             fast, per_chan):
    """``cbd_pfb_direct`` on CPU arrays against the float64 plain version:
    a nibble may differ by one code only within 1e-3 of a threshold.  The
    200-channel case takes two channel passes and a ragged last k slab;
    with int8 ADC and a multiple of 16 inputs the frames go through the
    shared-memory tile."""
    ntap = 4
    rng = np.random.RandomState(nchan + ninput)
    shape = ((nspec + ntap - 1) * 2 * nchan, ninput)
    if dtype == "int8":
        adc = rng.randint(-90, 91, shape).astype(np.int8)
    else:
        adc = (rng.randn(*shape) * 40).astype(np.float32)
    window = pfb.pfb_window(nchan, ntap)
    x, w = torch.from_numpy(adc), torch.from_numpy(window)
    re, _ = pfb.pfb_prequant_ref(x, w, nchan, ntap, 1.0)
    scale = np.full(nchan, 2.5 / float(re.std()), np.float32)
    if per_chan:
        scale *= rng.uniform(0.7, 1.3, nchan).astype(np.float32)
    table = torch.from_numpy(pfb_fused.direct_table_ref(nchan))
    if fast:
        table = pfb.bf16_round(table)
    table = np.ascontiguousarray(table.numpy())
    out = np.full((ninput, nspec, nchan), 0xAA, np.uint8)
    rc = lib.cbd_pfb_direct(
        ptr(adc), adc.strides[0] // adc.itemsize,
        adc.strides[1] // adc.itemsize, int(dtype == "int8"), ninput, nspec,
        nchan, ntap, ptr(window), ptr(table),
        table.shape[1] * pfb_fused.DIRECT_KS,
        table.shape[0] * pfb_fused.DIRECT_CPASS, ptr(scale), int(fast),
        ptr(out), None)
    assert rc == 0
    tolerated = pfb.assert_packed_matches_ref(
        torch.from_numpy(out), x, w, nchan, ntap, torch.from_numpy(scale),
        fast)
    assert tolerated <= 2
