"""Every source under ``csrc/`` (``corr_acc.cu``, ``corr_triu.cu``,
``corr_rows.cu``, ``subsel_gather.cu``, ``pfb_quantize.cu``, ``pfb_fft.cu``,
``beamform_products.cu``, with the header ``corr_tile.cuh`` they share)
compiled with g++ against ``tests/cuda_stub/cuda_runtime.h`` and run on
CPU arrays through their ``extern "C"`` launchers, against the plain
versions.

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
passes, int8 and float32 ADC, both precisions, under the packed-byte gate;
the factored channelizer (both DFT stages on the FP64 MMA, FIR fused in)
at 1024 channels the same way; the FFT channelizer (float64 real FFT, int8
frames through a shared-memory ring) at 192 and 96 channels, ragged tiles
and spectrum ranges, both frame load paths, float32 ADC, a structured and
a near-full-scale ADC, held also to the direct kernel's bytes.  The beamformer (bf16 MMA from a three-term
split of the gains) runs in both layouts at ragged inputs, beams, time
tiles and integration lengths against the float64 plain version, and
bit-exactly with integer gains.  The two gulp correlators run at ragged
inputs and times in both layouts, through both of their load paths (16-byte
cp.async, and bytes where a stride is not 16-byte aligned), the row
kernel over two 512-sample segments; the gather with out-of-range and
negative pairs.
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

from caltech_bifrost_dsp_tpu_torch.ops import beamform as bf
from caltech_bifrost_dsp_tpu_torch.ops import corr_blk as cb
from caltech_bifrost_dsp_tpu_torch.ops import corr_rows as cr
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.ops import corr_triu as ct
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
    for src in _build._sources():
        srcs.append(work / f"{src.stem}.cpp")
        srcs[-1].write_text(host_source(src.read_text()))
    so = work / "libkernels_host.so"
    # the headers are included from csrc as they are
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{STUB}", f"-I{_build.CSRC}", "-o", str(so),
                    *map(str, srcs)], check=True)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _build.SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def test_every_source_is_emulated():
    """The fixture builds every ``csrc/*.cu`` and binds every launcher:
    seven sources, ten launchers."""
    assert [p.name for p in _build._sources()] == [
        "beamform_products.cu", "corr_acc.cu", "corr_rows.cu",
        "corr_triu.cu", "pfb_fft.cu", "pfb_quantize.cu",
        "subsel_gather.cu"]
    assert sorted(_build.SIGNATURES) == sorted([
        "cbd_beamform_products", "cbd_corr_acc", "cbd_corr_acc_cached",
        "cbd_corr_blk", "cbd_corr_rows", "cbd_corr_triu",
        "cbd_pfb_direct", "cbd_pfb_factored", "cbd_pfb_fft",
        "cbd_subsel_gather"])


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


GULP = {"cbd_corr_triu": ct.corr_triu_ref, "cbd_corr_rows": cr.corr_rows_ref}
SENTINEL = 0x5A5A5A5A


# (kind, ntime, nchan, ninput, layout, pad, view): the channel stride (72)
# not 16-byte aligned, a ragged MMA step; the 16-byte path with a vector cut
# by ninput (140) over three chunks; all 0x88 in a padded cti block; tci at
# 300 inputs x 3 channels (time stride 900, not 16-byte aligned), three
# tiles; one sample; a shard view of a larger block over three segments of
# the row kernel (512 + 9 spectra)
GULP_CASES = [("random", 33, 2, 72, "tci", 0, False),
              ("structured", 70, 1, 140, "cti", 4, False),
              ("widest", 45, 2, 130, "cti", 14, False),
              ("random", 37, 3, 300, "tci", 0, False),
              ("structured", 1, 1, 256, "tci", 0, False),
              ("random", 521, 1, 140, "cti", 4, True)]


def gulp_block(kind, ntime, nchan, ni, layout, pad, view) -> np.ndarray:
    """A chan-major view [nchan, ntime, ni] of a packed block in
    ``layout``; ``view`` cuts it out of a larger block in chan and time."""
    if view:
        big = block(kind, ntime + 9, nchan + 2, ni + pad)
        return big[1:1 + nchan, 4:4 + ntime, :ni]
    if layout == "cti":
        return block(kind, ntime, nchan, ni + pad)[:, :, :ni]
    return np.ascontiguousarray(
        block(kind, ntime, nchan, ni).transpose(1, 0, 2)).transpose(1, 0, 2)


@pytest.mark.parametrize("name", sorted(GULP))
@pytest.mark.parametrize("kind,ntime,nchan,ni,layout,pad,view", GULP_CASES)
def test_gulp_correlator_emulated_matches_plain(lib, name, kind, ntime, nchan,
                                                ni, layout, pad, view):
    """``cbd_corr_triu`` (fused unpack per tile pair) and ``cbd_corr_rows``
    (row tile resident per segment) on CPU arrays: exact int32 on the tiles
    with tile(j) >= tile(i), which the first segment stores over what the
    planes held; the tiles below are never written."""
    xc = gulp_block(kind, ntime, nchan, ni, layout, pad, view)
    if layout == "tci" and not view:
        assert xc.strides[1] == nchan * ni     # the tci time stride
    out = [np.full((nchan, ni, ni), SENTINEL, np.int32) for _ in range(2)]
    rc = getattr(lib, name)(ptr(xc), xc.strides[0], xc.strides[1], nchan,
                            ntime, ni, ptr(out[0]), ptr(out[1]), None)
    assert rc == 0
    want = GULP[name](torch.from_numpy(np.ascontiguousarray(xc)))
    tile = np.arange(ni) // ct.TILE
    valid = tile[:, None] <= tile[None, :]
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g[:, valid], w.numpy()[:, valid])
        assert (g[:, ~valid] == SENTINEL).all()


@pytest.mark.parametrize("name", sorted(GULP))
def test_gulp_launchers_refuse_bad_arguments(lib, name):
    xc = np.zeros((1, 8, 16), np.uint8)
    out = np.zeros((1, 16, 16), np.int32)
    fn = getattr(lib, name)
    assert fn(ptr(xc), 128, 16, 1, 8, 16, ptr(out), ptr(out), None) == 0
    assert fn(ptr(xc), 128, 16, 0, 8, 16, ptr(out), ptr(out), None) != 0
    assert fn(ptr(xc), 128, 16, 1, -1, 16, ptr(out), ptr(out), None) != 0
    assert fn(ptr(xc), 128, 16, 1, 8, 0, ptr(out), ptr(out), None) != 0


def unaligned(shape, fill) -> np.ndarray:
    """An int32 array whose data start 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    raw = np.empty(4 * n + 32, np.uint8)
    skip = (4 - raw.ctypes.data) % 16
    out = raw[skip:skip + 4 * n].view(np.int32).reshape(shape)
    out[...] = fill
    return out


# (nchan, ninput, nvis, nchan_sum): every instantiation (1, 2, 4, 8) and
# the generic one (3, 6; 6 takes two chunks of its channel loop); nvis not
# a multiple of a thread's 4 outputs, so threads cross row ends; more
# outputs than the stub's one wave (3 SMs x 1 block x 64 threads x 4), so
# the grid strides; fewer baselines than a thread's outputs
SUBSEL_CASES = [
    (8, 20, 300, 4), (3, 7, 5, 1), (6, 33, 40, 6), (16, 24, 301, 2),
    (16, 24, 98, 8), (9, 11, 203, 3), (12, 10, 3, 4), (2, 9, 1, 1)]


def run_subsel(lib, nchan, ni, nvis, nchan_sum, make_out) -> None:
    rng = np.random.RandomState(nvis + ni)
    vis = [rng.randint(-2 ** 30, 2 ** 30, (nchan, ni, ni)).astype(np.int32)
           for _ in range(2)]
    pairs = rng.randint(0, ni, (nvis, 2)).astype(np.int32)
    pairs[:3] = [[ni + 5, 2], [-3, ni - 1], [1, -40]][:nvis]
    out = [make_out((nchan // nchan_sum, nvis)) for _ in range(2)]
    rc = lib.cbd_subsel_gather(ptr(vis[0]), ptr(vis[1]), nchan, ni,
                               ptr(pairs), nvis, nchan_sum, ptr(out[0]),
                               ptr(out[1]), None)
    assert rc == 0
    want = cs.corr_subsel_ref(Vis(*map(torch.from_numpy, vis)),
                              torch.from_numpy(pairs), nchan_sum)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w.numpy())


# (nchan, ninput, nvis, nchan_sum): every instantiation (1, 2, 4, 8) and
# the generic one (3, 6; 6 takes two chunks of its channel loop); nvis not
# a multiple of a thread's 4 outputs, so threads cross row ends; more
# outputs than the stub's one wave (3 SMs x 1 block x 64 threads x 4), so
# the grid strides; fewer baselines than a thread's outputs
@pytest.mark.parametrize("nchan,ni,nvis,nchan_sum", SUBSEL_CASES)
def test_subsel_gather_emulated_matches_plain(lib, nchan, ni, nvis,
                                              nchan_sum):
    """``cbd_subsel_gather`` against the plain gather: both orders of a
    pair (the conjugated one flips the imaginary sign), and pairs out of
    range or negative, which clamp to [0, ninput - 1] first; the outputs
    are 16-byte aligned, so full groups of 4 leave as 16-byte stores."""

    def make_out(shape):
        out = np.full(shape, SENTINEL, np.int32)
        assert out.ctypes.data % 16 == 0
        return out

    run_subsel(lib, nchan, ni, nvis, nchan_sum, make_out)


def unaligned(shape) -> np.ndarray:
    """An int32 array whose data start 4 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    raw = np.empty(4 * n + 32, np.uint8)
    skip = (4 - raw.ctypes.data) % 16
    out = raw[skip:skip + 4 * n].view(np.int32).reshape(shape)
    out[...] = SENTINEL
    return out


@pytest.mark.parametrize("nchan,ni,nvis,nchan_sum", SUBSEL_CASES[3:6])
def test_subsel_gather_emulated_unaligned_outputs(lib, nchan, ni, nvis,
                                                  nchan_sum):
    """Outputs that are not 16-byte aligned take 4-byte stores."""
    run_subsel(lib, nchan, ni, nvis, nchan_sum, unaligned)


def test_subsel_gather_refuses_bad_arguments(lib):
    vis = np.zeros((4, 8, 8), np.int32)
    pairs = np.zeros((2, 2), np.int32)
    out = np.zeros(8, np.int32)

    def call(nchan, ni, nchan_sum):
        return lib.cbd_subsel_gather(ptr(vis), ptr(vis), nchan, ni,
                                     ptr(pairs), 2, nchan_sum, ptr(out),
                                     ptr(out), None)

    assert call(4, 8, 2) == 0
    assert call(4, 8, 3) != 0       # nchan_sum does not divide nchan
    assert call(4, 8, 0) != 0
    assert call(4, 0, 2) != 0


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



def fft_adc(kind: str, nchan: int, ntap: int, nspec: int, ninput: int,
            strided: bool, rng) -> np.ndarray:
    """ADC [ntime, ninput] for the FFT kernel's cases; ``strided`` takes
    every second column of one twice as wide."""
    shape = ((nspec + ntap - 1) * 2 * nchan, ninput * (2 if strided else 1))
    if kind == "float32":
        wide = (rng.randn(*shape) * 40).astype(np.float32)
    elif kind == "int8":
        wide = rng.randint(-90, 91, shape).astype(np.int8)
    elif kind == "full":
        # near full scale: every sample +-(120..128)
        mag = rng.randint(120, 129, shape)
        wide = np.where(rng.rand(*shape) < 0.5, -mag,
                        np.minimum(mag, 127)).astype(np.int8)
    else:
        # structured: a distinct value per input and per sample
        t, i = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                           indexing="ij")
        wide = ((7 * i + 13 * t) % 255 - 127).astype(np.int8)
    return wide[:, ::2] if strided else wide


# (nchan, nspec, ninput, kind, strided, per_chan, ntap): 48 inputs take
# 16-byte frame loads, one full and one half tile; 40 and a strided view
# take byte loads, 40 a ragged tile; 20 and 16 inputs are one tile, so the
# stub's three resident blocks split the spectra into ragged ranges
# (7 -> 3 + 3 + 1, 5 -> 2 + 2 + 1); float32 reads device memory; ntap 4
# is unrolled at compile time, 2 and 5 loop
FFT_CASES = [
    (192, 5, 48, "int8", False, True, 4), (192, 4, 40, "int8", False, False,
                                           4),
    (192, 3, 5, "float32", True, True, 4), (192, 3, 32, "structured",
                                            False, False, 4),
    (96, 7, 20, "int8", False, True, 4), (96, 5, 16, "full", False, False,
                                          4),
    (96, 4, 33, "int8", True, True, 4), (96, 5, 32, "float32", False, False,
                                         4),
    (192, 4, 48, "int8", False, False, 2), (96, 5, 20, "int8", True, True,
                                            5)]


@pytest.mark.parametrize("nchan,nspec,ninput,kind,strided,per_chan,ntap",
                         FFT_CASES)
def test_pfb_fft_emulated_passes_the_gate(lib, nchan, nspec, ninput, kind,
                                          strided, per_chan, ntap):
    """``cbd_pfb_fft`` on CPU arrays, under the packed-byte gate against
    the float64 plain version and against ``cbd_pfb_direct``'s bytes on
    the same ADC: a nibble may differ from either by one code only within
    1e-3 of a rounding threshold, at most twice."""
    rng = np.random.RandomState(nchan + 10 * ninput + nspec)
    adc = fft_adc(kind, nchan, ntap, nspec, ninput, strided, rng)
    window = pfb.pfb_window(nchan, ntap)
    x = torch.from_numpy(np.ascontiguousarray(adc))
    w = torch.from_numpy(window)
    re, _ = pfb.pfb_prequant_ref(x, w, nchan, ntap, 1.0)
    scale = np.full(nchan, 2.5 / float(re.std()), np.float32)
    if per_chan:
        scale *= rng.uniform(0.7, 1.3, nchan).astype(np.float32)
    is_int8 = int(adc.dtype == np.int8)
    st = (adc.strides[0] // adc.itemsize, adc.strides[1] // adc.itemsize)
    tw = pfb_fused.fft_twiddles_ref(nchan)
    out = np.full((ninput, nspec, nchan), 0xAA, np.uint8)
    rc = lib.cbd_pfb_fft(ptr(adc), *st, is_int8, ninput, nspec, nchan, ntap,
                         ptr(window), ptr(tw), ptr(scale), ptr(out), None)
    assert rc == 0
    got = torch.from_numpy(out)
    tolerated = pfb.assert_packed_matches_ref(
        got, x, w, nchan, ntap, torch.from_numpy(scale))
    assert tolerated <= 2
    table = np.ascontiguousarray(pfb_fused.direct_table_ref(nchan))
    direct = np.full_like(out, 0x55)
    rc = lib.cbd_pfb_direct(
        ptr(adc), *st, is_int8, ninput, nspec, nchan, ntap, ptr(window),
        ptr(table), table.shape[1] * pfb_fused.DIRECT_KS,
        table.shape[0] * pfb_fused.DIRECT_CPASS, ptr(scale), 0, ptr(direct),
        None)
    assert rc == 0
    pre = pfb.pfb_prequant_ref(x, w, nchan, ntap, torch.from_numpy(scale))
    assert pfb.assert_packed_close(got, torch.from_numpy(direct), pre) <= 2


def test_pfb_fft_refuses_what_it_does_not_take(lib):
    """Channel counts it is not compiled for, ntap past its shared memory,
    an output that is not 16-byte aligned."""
    nchan, ninput = 192, 16
    window = pfb.pfb_window(nchan, 8)
    tw = pfb_fused.fft_twiddles_ref(nchan)
    scale = np.ones(nchan, np.float32)
    adc = np.zeros((10 * 2 * nchan, ninput), np.int8)
    out = np.zeros(ninput * 2 * nchan + 16, np.uint8)
    skip = (16 - out.ctypes.data % 16) % 16

    def call(nchan, ntap, offset=skip):
        return lib.cbd_pfb_fft(ptr(adc), ninput, 1, 1, ninput, 1, nchan,
                               ntap, ptr(window), ptr(tw), ptr(scale),
                               ptr(out) + offset, None)

    assert call(192, 4) == 0
    assert call(184, 4) != 0 and call(128, 4) != 0
    ntap_max = max(t for t in range(1, 9)
                   if pfb_fused.fft_takes(nchan, t, torch.int8))
    assert call(192, ntap_max) == 0 and call(192, ntap_max + 1) != 0
    assert call(192, 4, skip + 1) != 0


@pytest.mark.parametrize(
    "nchan,nspec,ninput,dtype,fast,per_chan,strided,chunk", [
        (1024, 2, 3, "int8", False, False, False, 2),
        (1024, 1, 16, "int8", False, True, False, 1),
        (1024, 1, 2, "float32", False, True, True, 1),
        (1024, 2, 2, "int8", True, False, True, 1),
        (1024, 1, 3, "float32", True, True, False, 1),
        (8192, 1, 1, "int8", False, False, False, 1)])
def test_pfb_factored_emulated_passes_the_gate(lib, nchan, nspec, ninput,
                                               dtype, fast, per_chan,
                                               strided, chunk):
    """``cbd_pfb_factored`` at 1024 channels (L = 2048 = 64 x 32) on CPU
    arrays against the float64 plain version under the packed-byte gate:
    both stages on the FP64 MMA, the mirrored half of stage 1, the bf16
    rounding of the twiddled intermediate, a strided ADC (every second
    column of a wider array), per-channel scale, spectra run in chunks of
    the FIR scratch, and with 16 int8 inputs the FIR kernel of 16-byte
    loads.  8192 channels (128 x 128) take two groups of stage-1 column
    tiles a warp."""
    ntap = 4
    L1, L2 = pfb._dft_factors(2 * nchan)
    rng = np.random.RandomState(nspec * 10 + ninput)
    shape = ((nspec + ntap - 1) * 2 * nchan, ninput * (2 if strided else 1))
    if dtype == "int8":
        wide = rng.randint(-90, 91, shape).astype(np.int8)
    else:
        wide = (rng.randn(*shape) * 40).astype(np.float32)
    adc = wide[:, ::2] if strided else wide
    window = pfb.pfb_window(nchan, ntap)
    x = torch.from_numpy(np.ascontiguousarray(adc))
    w = torch.from_numpy(window)
    re, _ = pfb.pfb_prequant_ref(x, w, nchan, ntap, 1.0)
    scale = np.full(nchan, 2.5 / float(re.std()), np.float32)
    if per_chan:
        scale *= rng.uniform(0.7, 1.3, nchan).astype(np.float32)
    tables = [torch.from_numpy(t) for t in
              pfb_fused.factored_tables_ref(nchan, half=not fast)]
    if fast:
        tables[0], tables[2] = (pfb.bf16_round(tables[0]),
                                pfb.bf16_round(tables[2]))
    inner, tw, outer = (np.ascontiguousarray(t.numpy()) for t in tables)
    scratch = np.full((ninput, chunk, 2 * nchan), np.nan, np.float32)
    out = np.full((ninput, nspec, nchan), 0xAA, np.uint8)
    rc = lib.cbd_pfb_factored(
        ptr(adc), adc.strides[0] // adc.itemsize,
        adc.strides[1] // adc.itemsize, int(dtype == "int8"), ninput, nspec,
        nchan, ntap, L1, L2, ptr(window), ptr(inner), ptr(tw), ptr(outer),
        ptr(scale), int(fast), ptr(scratch), chunk, ptr(out), None)
    assert rc == 0
    tolerated = pfb.assert_packed_matches_ref(
        torch.from_numpy(out), x, w, nchan, ntap, torch.from_numpy(scale),
        fast)
    assert tolerated <= 2

def close(got: np.ndarray, want: torch.Tensor) -> None:
    """The reference's beam gate: rtol 1e-4, atol 1e-4 * max|truth|."""
    want = want.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ragged inputs and two beams; every row tile, a padded cti block; a ragged
# last time tile (tt = 192); ragged inputs over two chunks with an
# integration length that is no multiple of the 8-sample MMA tile
@pytest.mark.parametrize(
    "ntime,nchan,ni,nbeam,ntime_sum,layout,products,integer", [
        (48, 2, 20, 2, 1, "tci", "pv", False),
        (48, 1, 96, 32, 24, "cti", "pv", False),
        (288, 1, 64, 4, 96, "tci", "pv", True),
        (50, 1, 40, 18, 25, "cti", "p", False),
        (24, 2, 33, 6, 24, "tci", "v", True)])
def test_beamform_emulated_matches_plain(lib, ntime, nchan, ni, nbeam,
                                         ntime_sum, layout, products,
                                         integer):
    """``cbd_beamform_products`` on CPU arrays: the gain prepass equals
    the plain split word for word; power and VLBI pass the beam gate
    against the float64 plain version (VLBI bit-exact with integer gains);
    pad lanes past ninput hold garbage and an absent product is skipped."""
    rng = np.random.RandomState(ntime + ni)
    pad = 12 if layout == "cti" else 0
    if layout == "cti":
        blk = rng.randint(0, 256, (nchan, ntime, ni + pad)).astype(np.uint8)
        xc = blk[:, :, :ni]
    else:
        blk = rng.randint(0, 256, (ntime, nchan, ni)).astype(np.uint8)
        xc = blk.transpose(1, 0, 2)
    if integer:
        gr, gi = (rng.randint(-8, 9, (nchan, nbeam, ni)).astype(np.float32)
                  for _ in range(2))
    else:
        gr, gi = (rng.randn(nchan, nbeam, ni).astype(np.float32)
                  for _ in range(2))
    gains = bf.BeamGains(torch.from_numpy(gr), torch.from_numpy(gi))
    want_p, want_v = bf.beamform_products_ref(
        torch.from_numpy(np.ascontiguousarray(xc)), gains, ntime_sum)
    gsplit = np.full(bf.split_shape(nchan, ni), 0x55, np.int32)
    power = np.full(tuple(want_p.shape), np.nan, np.float32)
    vlbi = np.full(tuple(want_v.shape), np.nan, np.float32)
    rc = lib.cbd_beamform_products(
        ptr(xc), xc.strides[0], xc.strides[1], nchan, ntime, ni, ptr(gr),
        ptr(gi), nbeam, ntime_sum, ptr(gsplit), gsplit.size,
        ptr(power) if "p" in products else None,
        ptr(vlbi) if "v" in products else None, None)
    assert rc == 0
    np.testing.assert_array_equal(gsplit, bf.split_gains_ref(gains).numpy())
    if "p" in products:
        close(power, want_p)
    else:
        assert np.isnan(power).all()
    if "v" not in products:
        assert np.isnan(vlbi).all()
    elif integer:
        np.testing.assert_array_equal(vlbi, want_v.numpy())
    else:
        close(vlbi, want_v)


def test_gain_split_terms_sum_to_the_gain():
    """Gains across forty decades split into three bf16 terms whose sum is
    the gain exactly (the plain split, which the emulated prepass equals
    word for word)."""
    rng = np.random.RandomState(9)
    g = (rng.randn(2, 4, 40) * 10.0 ** rng.uniform(-20, 20, (2, 4, 40))
         ).astype(np.float32)
    gains = bf.BeamGains(torch.from_numpy(g),
                         torch.from_numpy(g[::-1].copy()))
    words = bf.split_gains_ref(gains)
    for half, plane in enumerate(gains):
        total = sum((((words[:, :, s] >> (16 * half)) & 0xFFFF) << 16)
                    .view(torch.float32).double()
                    for s in range(bf.SPLIT_TERMS))
        total = total.permute(0, 2, 1, 3).reshape(2, 32, -1)[:, :4, :40]
        assert torch.equal(total, plane.double())


def test_beamform_launcher_refuses_bad_arguments(lib):
    xc = np.zeros((1, 8, 16), np.uint8)
    g = np.zeros((1, 2, 16), np.float32)
    gsplit = np.zeros(bf.split_shape(1, 16), np.int32)
    out = np.zeros(64, np.float32)

    def call(nbeam, ntime_sum, words):
        return lib.cbd_beamform_products(
            ptr(xc), xc.strides[0], xc.strides[1], 1, 8, 16, ptr(g), ptr(g),
            nbeam, ntime_sum, ptr(gsplit), words, ptr(out), None, None)

    assert call(2, 4, gsplit.size) == 0
    assert call(3, 4, gsplit.size) != 0          # odd nbeam
    assert call(2, 3, gsplit.size) != 0          # ntime_sum does not divide
    assert call(2, 4, gsplit.size - 1) != 0      # short scratch
