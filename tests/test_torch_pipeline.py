"""The port's source, golden tools, served driver and CLI vs the JAX
package.

The golden CLI gate: JAX ``make_golden`` writes the files, the port's CLI
(``--device cpu``) must exit 0 on them and 1 on a corrupted corr file."""

import dataclasses
import json

import socket

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.scripts import make_golden
from caltech_bifrost_dsp_tpu.scripts.tpu_parity import (host_beams,
                                                        host_corr_int32,
                                                        host_power)
from caltech_bifrost_dsp_tpu.verification import golden as jgolden
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.io import native
from caltech_bifrost_dsp_tpu_torch.io.source import SyntheticSource
from caltech_bifrost_dsp_tpu_torch.ops import corr_subsel as cs
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.scripts import pipeline
from caltech_bifrost_dsp_tpu_torch.verification import golden
from torch_kept_run import kept_pipeline, kept_run

torch.set_num_threads(1)

CFG = C.TINY
#: the port's config, from the JAX one field by field
PCFG = TC.XEngineConfig(**dataclasses.asdict(CFG))


def _golden_files(tmp_path, ntime, nchan=16, nstand=16, acc=240):
    make_golden.main(["-t", str(ntime), "-c", str(nchan), "-s", str(nstand),
                      "-p", "2", "--accshort", str(acc), "--datapath",
                      str(tmp_path)])
    return (jgolden.input_filename(str(tmp_path), ntime, nchan, nstand, 2),
            jgolden.corr_filename(str(tmp_path), ntime, acc, nchan, nstand,
                                  2))


def _cli(in_path, corr_path, ntime):
    return pipeline.main([
        "--fakesource", "--testdatain", in_path, "--testdatacorr", corr_path,
        "--testdatacorr_acc_len", "240", "--nchan", "16", "--nstand", "16",
        "--nbeam", "4", "--ntime_gulp", "48", "--acc_len", "240",
        "--acc_len_slow", "480", "--ngulp", str(ntime // 48),
        "--device", "cpu"])


def test_cli_golden_gate_passes(tmp_path, capsys):
    ntime = 960  # two slow accumulations
    assert _cli(*_golden_files(tmp_path, ntime), ntime) == 0
    assert "golden check: 2/2 passed" in capsys.readouterr().out


def test_cli_golden_gate_detects_corruption(tmp_path):
    ntime = 480
    in_path, corr_path = _golden_files(tmp_path, ntime)
    with open(corr_path, "r+b") as fh:
        fh.seek(4096)
        b = fh.read(1)
        fh.seek(4096)
        fh.write(bytes([b[0] ^ 0xFF]))
    assert _cli(in_path, corr_path, ntime) == 1


def test_cli_requires_fakesource():
    """Without ``--fakesource`` the CLI reads UDP capture and never falls
    back to a synthetic stream: its source is ``native.CaptureSource`` on
    the given address (a run: tests/test_torch_over_the_wire.py), and
    float32 ADC, which only the synthetic source makes, is refused."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = pipeline.build_parser().parse_args(
        ["--ip", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--nstand", "16", "--nchan", "16", "--nbeam", "4", "--ntime_gulp",
         "48", "--acc_len", "240", "--acc_len_slow", "480"])
    pipe, _ = pipeline.build_pipeline(args)
    try:
        assert type(pipe.source) is native.CaptureSource
    finally:
        pipe.source.close()
    with pytest.raises(SystemExit) as exc:
        pipeline.main(["--device", "cpu", "--ngulp", "1", "--fx",
                       "--port", str(port)])
    assert exc.value.code != 0


@pytest.mark.parametrize("mode", ["ramp", "random", "testfile"])
def test_synthetic_source_matches_dummy_source(tmp_path, mode):
    testfile = None
    if mode == "testfile":
        testfile, _ = _golden_files(tmp_path, 240)
    want = jsource.DummySource(CFG, mode=mode, testfile=testfile, seed=9)
    got = SyntheticSource(PCFG, mode=mode, testfile=testfile, seed=9)
    for (t0, a), (t1, b) in zip(want.stream(7, seq0=96),
                                got.stream(7, seq0=96)):
        assert t0 == t1
        np.testing.assert_array_equal(a, b)


def test_golden_tools_match_jax(tmp_path):
    args = (96, 4, 3, 2, 48)
    for name in ("in", "corr"):
        ours = tmp_path / f"ours_{name}.dat"
        theirs = tmp_path / f"jax_{name}.dat"
        writer = "write_input_file" if name == "in" else "write_corr_file"
        getattr(golden, writer)(str(ours), *args, timestamp=1.5)
        getattr(jgolden, writer)(str(theirs), *args, timestamp=1.5)
        assert ours.read_bytes() == theirs.read_bytes()
        m0, d0 = golden.read_dat(str(ours))
        m1, d1 = jgolden.read_dat(str(theirs))
        assert m0 == m1
        np.testing.assert_array_equal(d0, d1)
    for fn in ("input_filename",):
        assert getattr(golden, fn)("/d", 96, 4, 3, 2) == \
            getattr(jgolden, fn)("/d", 96, 4, 3, 2)
    assert golden.corr_filename("/d", 96, 48, 4, 3, 2, chanramp=True) == \
        jgolden.corr_filename("/d", 96, 48, 4, 3, 2, chanramp=True)
    block = next(golden.generate_input_blocks(48, 4, 3, 2, 48))
    ref = golden.reference_correlation(block)
    vr, vi = golden.host_corr_int32(block)
    dense = vr.astype(np.complex128) + 1j * vi
    assert golden.check_vis_against_golden(dense, ref)
    assert jgolden.check_vis_against_golden(dense, ref)


def test_host_truths_match_jax_parity_script():
    rng = np.random.RandomState(3)
    block = rng.randint(0, 255, (48, 4, 6, 2)).astype(np.uint8)
    for a, b in zip(golden.host_corr_int32(block), host_corr_int32(block)):
        np.testing.assert_array_equal(a, b)
    gr = rng.randn(4, 4, 12).astype(np.float32)
    gi = rng.randn(4, 4, 12).astype(np.float32)
    br, bi = golden.host_beams(block, gr, gi)
    jbr, jbi = host_beams(block, gr, gi)
    np.testing.assert_array_equal(br, jbr)
    np.testing.assert_array_equal(golden.host_power(br, bi, 12),
                                  host_power(jbr, jbi, 12))


def _truth(gulps, nchan_sum, pairs):
    """Exact dense visibilities and subselection of a run of gulps."""
    block = np.concatenate(gulps).reshape(-1, CFG.nchan, CFG.nstand, 2)
    vr, vi = golden.host_corr_int32(block)
    i0, i1 = pairs[:, 0], pairs[:, 1]

    def csum(x):
        return x.reshape(CFG.nchan // nchan_sum, nchan_sum, -1).sum(1)

    return vr, vi, (csum(vr[:, i0, i1]), csum(vi[:, i0, i1]))


def test_runner_products_are_exact():
    """The served driver, one step call a window: fast dumps (subsel),
    slow dumps and beams against host truth over two slow
    accumulations."""
    gulps = [g for _, g in SyntheticSource(PCFG, mode="random",
                                           seed=5).stream(20)]
    rng = np.random.RandomState(6)
    gr = rng.randint(-8, 9, (CFG.nchan, CFG.nbeam, CFG.ninput))
    gi = rng.randint(-8, 9, (CFG.nchan, CFG.nbeam, CFG.ninput))
    pairs = cs.baselines_to_inputs(
        cs.production_baselines(24, CFG.nstand)).astype(np.int32)
    pipe, kept = kept_run(PCFG, SyntheticSource(PCFG, mode="random", seed=5),
                          20, gains=gr + 1j * gi, pairs=pairs)
    gpw = CFG.acc_len // CFG.ntime_gulp                 # 5 gulps per call
    starts = [w * CFG.acc_len for w in range(4)]
    assert list(kept.vlbi) == list(kept.subsel) == starts
    assert (pipe.ndump_fast, pipe.ndump_slow) == (4, 2)
    assert list(kept.slow) == [0, 2 * CFG.acc_len]
    for w, t in enumerate(starts):
        win = gulps[w * gpw:(w + 1) * gpw]
        _, _, (sr, si) = _truth(win, CFG.nchan_sum, pairs)
        np.testing.assert_array_equal(kept.subsel[t][0], sr)
        np.testing.assert_array_equal(kept.subsel[t][1], si)
        block = np.concatenate(win).reshape(-1, CFG.nchan, CFG.nstand, 2)
        br, bi = golden.host_beams(block, gr.astype(np.float32),
                                   gi.astype(np.float32))
        want_v = np.stack([br[:, :2], bi[:, :2]], -1).transpose(2, 0, 1, 3)
        np.testing.assert_array_equal(kept.vlbi[t], want_v)
        hp = host_power(br, bi, CFG.ntime_sum)
        np.testing.assert_allclose(kept.power[t], hp, rtol=1e-4,
                                   atol=1e-4 * np.abs(hp).max())
        if w % 2:
            vr, vi, _ = _truth(gulps[(w - 1) * gpw:(w + 1) * gpw],
                               CFG.nchan_sum, pairs)
            slow = kept.slow[(w - 1) * CFG.acc_len]
            np.testing.assert_array_equal(slow[0], vr)
            np.testing.assert_array_equal(slow[1], vi)


def test_runner_per_gulp_fallback_for_partial_accumulation():
    """A ``Corr`` command that lengthens the fast window lands after the
    window's batch size was fixed, so the window runs as per-gulp step
    calls with the right flags."""
    gulps = [g for _, g in SyntheticSource(PCFG, mode="random",
                                           seed=7).stream(12)]
    pairs = np.array([[0, 1], [3, 2]], np.int32)
    store = MemoryStore()
    pipe, kept = kept_pipeline(
        PCFG, SyntheticSource(PCFG, mode="random", seed=7), pairs=pairs,
        store=store)
    stage_loads = pipe.beam_cmd.stage_loads

    def command_at_start(t):
        # staged after the first window's commands were applied, so it
        # lands at the second window, once its batch size is fixed
        if t == 0:
            store.put(pipe.corr_cmd.command_key, json.dumps({
                "cmd": "update", "id": "acc", "val": {"kwargs": {
                    "start_time": 5 * CFG.ntime_gulp,
                    "acc_len": 7 * CFG.ntime_gulp}}}))
        return stage_loads(t)

    pipe.beam_cmd.stage_loads = command_at_start
    pipe.run(12, timeout_s=300)
    # gulps 0-4 in one call, then gulps 5-11 one by one
    assert list(kept.vlbi) == [k * CFG.ntime_gulp
                               for k in [0, *range(5, 12)]]
    assert list(kept.subsel) == [0, 5 * CFG.ntime_gulp]
    _, _, (sr, si) = _truth(gulps[5:12], CFG.nchan_sum, pairs)
    np.testing.assert_array_equal(kept.subsel[5 * CFG.ntime_gulp][0], sr)
    np.testing.assert_array_equal(kept.subsel[5 * CFG.ntime_gulp][1], si)


def test_runner_autostart_skips_until_armed():
    pipe, kept = kept_run(PCFG, SyntheticSource(PCFG, mode="ramp"), 15,
                          autostartat=2 * CFG.acc_len)
    assert list(kept.vlbi) == [2 * CFG.acc_len] and pipe.ndump_fast == 1
