"""The port's transient voltage recorder against the JAX package's.

The same frames pushed into both packages' history rings give byte-equal
``.tbf`` files, buffered and with O_DIRECT; each package's
``TriggerFileSource`` reads the other's files; the sequence headers the
files carry are equal; and a trigger through the control plane of a
running pipeline (packed and FX, float32 and int8 ADC) writes the files
the JAX driver writes.  Also: the ADC ``seq0`` unit, the skip forward when
capture laps the dump, the abort latch, and ``build_pipeline_from_json``.
"""

import dataclasses
import glob
import json
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control.client import (
    CorrControlClient as JClient, PipelineControl as JPipelineControl)
from caltech_bifrost_dsp_tpu.control.store import MemoryStore as JStore
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.runtime import driver as jdriver
from caltech_bifrost_dsp_tpu.runtime.ring import HistoryRing as JRing
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.client import (CorrControlClient,
                                                          PipelineControl)
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.runtime import driver
from caltech_bifrost_dsp_tpu_torch.runtime.ring import HistoryRing
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)

CFG = C.TINY
PCFG = TC.XEngineConfig(**dataclasses.asdict(CFG))
SYNC = 1_700_000_000
HOST = socket.gethostname()
# FX: as tests/test_fx_driver.py
FX_CFG = C.XEngineConfig(nstand=8, nchan=32, ntime_gulp=48, acc_len=96,
                         acc_len_slow=192, nbeam=4, ntime_sum=12,
                         nchan_sum=4, npipeline=2, pfb_ntap=4)


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def both_rings(nbyte, frame_nbyte, header, frames, frame0_seq=0):
    """A JAX and a port history ring holding the same frames."""
    rings = (JRing(nbyte, frame_nbyte), HistoryRing(nbyte, frame_nbyte))
    for r in rings:
        r.set_header(header, frame0_seq=frame0_seq)
        for f in frames:
            r.push(f)
    return rings


def read_bytes(path) -> bytes:
    return Path(path).read_bytes()


def test_headers_match_jax():
    """The JSON header a dump file carries comes from the sequence header:
    keys, values and order equal the JAX source's."""
    j = jsource.sequence_header(CFG, seq0=960, sync_time=SYNC, time_tag=3)
    p = source.sequence_header(PCFG, seq0=960, sync_time=SYNC, time_tag=3)
    assert json.dumps(p) == json.dumps(j)
    for dtype in ("float32", "int8"):
        jc = FX_CFG.replace(adc_dtype=dtype)
        pc = TC.XEngineConfig(**dataclasses.asdict(jc))
        jh = jsource.ADCSource(jc).header(seq0=48, sync_time=SYNC)
        ph = source.ADCSource(pc).header(seq0=48, sync_time=SYNC)
        assert json.dumps(ph) == json.dumps(jh)
        assert ph["nbit"] == (8 if dtype == "int8" else 32)


@pytest.mark.parametrize("direct", [False, True])
def test_dump_files_equal_jax_and_replay_across(tmp_path, direct):
    """tests/test_io.py::test_triggered_dump_and_replay: 100 frames into a
    64-frame ring, two files of 32 frames from the earliest (frame 36)."""
    frame_nbyte = CFG.nchan * CFG.ninput
    hdr = jsource.sequence_header(CFG, seq0=0, sync_time=SYNC)
    frames = np.random.RandomState(3).randint(
        0, 256, [100, frame_nbyte]).astype(np.uint8)
    jring, pring = both_rings(64 * frame_nbyte, frame_nbyte, hdr, frames)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jfiles = jsink.TriggeredDump(jring, dump_path=str(tmp_path / "j"),
                                 direct=direct).trigger(32, nfile=2)
    pd = sink.TriggeredDump(pring, dump_path=str(tmp_path / "p"),
                            direct=direct)
    pfiles = pd.trigger(32, nfile=2)
    assert [Path(f).name for f in pfiles] == [Path(f).name for f in jfiles]
    assert len(pfiles) == 2
    for jf, pf in zip(jfiles, pfiles):
        assert read_bytes(pf) == read_bytes(jf)
    # the port reads the JAX file and the JAX package the port's
    h, data = source.TriggerFileSource(jfiles[0]).read()
    assert h["ntime"] == 32 and h["seq0"] == 36
    np.testing.assert_array_equal(data.reshape(32, -1), frames[36:68])
    hj, dj = jsource.TriggerFileSource(pfiles[1]).read()
    assert hj == source.TriggerFileSource(pfiles[1]).header
    np.testing.assert_array_equal(dj.reshape(32, -1), frames[68:100])
    seqs = [s for s, _ in source.TriggerFileSource(pfiles[0]).gulps(8)]
    assert seqs == [36 + 8 * i for i in range(4)]
    assert seqs == [s for s, _ in
                    jsource.TriggerFileSource(pfiles[0]).gulps(8)]
    assert pd.last_direct in ((False,) if not direct else (False, True))


def test_direct_and_buffered_files_are_equal(tmp_path, rng):
    """tests/test_io.py::test_triggered_dump_direct_io: a frame size that
    is no multiple of a page, so the direct writer appends a buffered
    tail; the bytes equal the buffered and the JAX files."""
    frame_nbyte = 4 * 16 * 2
    hdr = {"nchan": 4, "nstand": 16, "npol": 2, "seq0": 0}
    frames = [rng.randint(0, 256, frame_nbyte).astype(np.uint8)
              for _ in range(32)]
    jring, pring = both_rings(64 * frame_nbyte, frame_nbyte, hdr, frames)
    out = {}
    for name, mod, ring, direct in (("jb", jsink, jring, False),
                                    ("jd", jsink, jring, True),
                                    ("pb", sink, pring, False),
                                    ("pd", sink, pring, True)):
        d = mod.TriggeredDump(ring, dump_path=str(tmp_path),
                              file_prefix=name, direct=direct)
        out[name] = read_bytes(d.trigger(ntime_per_file=32 * 128,
                                         nfile=1)[0])
    assert out["pb"] == out["pd"] == out["jb"] == out["jd"]
    size = int.from_bytes(out["pd"][:8], "little")
    assert size == len(out["pd"]) == sink.TriggeredDump.HEADER_BLOCK \
        + 32 * frame_nbyte


def test_adc_seq0_in_spectra_units(tmp_path):
    """tests/test_io.py::test_triggered_dump_adc_seq0_in_spectra_units:
    10 int8 ADC frames into a 4-frame ring; seq0 counts output spectra
    (6 frames x ntime_gulp), the file holds one frame of sample rows."""
    nchan, ninput, ntime_gulp = 4, 8, 6
    rows_per_frame = ntime_gulp * 2 * nchan
    frame_nbyte = rows_per_frame * ninput
    hdr = {"adc": True, "nbit": 8, "nchan": nchan, "nstand": 4,
           "npol": 2, "ntime_gulp": ntime_gulp}
    frames = np.random.RandomState(5).randint(
        0, 256, [10, frame_nbyte]).astype(np.uint8)
    jring, pring = both_rings(4 * frame_nbyte, frame_nbyte, hdr, frames)
    (tmp_path / "j").mkdir()
    jf = jsink.TriggeredDump(jring, dump_path=str(tmp_path / "j")).trigger(
        ntime_per_file=rows_per_frame, nfile=1)[0]
    pf = sink.TriggeredDump(pring, dump_path=str(tmp_path)).trigger(
        ntime_per_file=rows_per_frame, nfile=1)[0]
    assert read_bytes(pf) == read_bytes(jf)
    h, data = source.TriggerFileSource(pf).read()
    assert h["seq0"] == 6 * ntime_gulp
    assert h["ntime"] == rows_per_frame
    assert data.dtype == np.int8 and data.shape == (rows_per_frame, 8)
    np.testing.assert_array_equal(data.reshape(-1).view(np.uint8),
                                  frames[6])


def test_dump_skips_forward_when_capture_laps(tmp_path):
    """tests/test_io.py::test_triggered_dump_survives_capture_lapping: the
    capture laps the cursor between ``earliest()`` and ``snapshot()``; the
    dump skips to the earliest resident frame and completes."""
    frame_nbyte = 64
    ring = HistoryRing(nbyte=4 * frame_nbyte, frame_nbyte=frame_nbyte)
    ring.set_header({"nchan": 1, "nstand": 8, "npol": 1}, frame0_seq=0)
    rng = np.random.RandomState(6)
    pushed = [rng.randint(0, 256, frame_nbyte).astype(np.uint8)
              for _ in range(11)]
    for f in pushed[:6]:
        ring.push(f)
    orig_snapshot = ring.snapshot
    state = {"lapped": False}

    def lapping_snapshot(lo, n):
        if not state["lapped"]:
            state["lapped"] = True
            for f in pushed[6:]:        # the capture laps the cursor
                ring.push(f)
            raise IndexError("requested frames not resident")
        return orig_snapshot(lo, n)

    ring.snapshot = lapping_snapshot
    files = sink.TriggeredDump(ring, dump_path=str(tmp_path)).trigger(
        ntime_per_file=frame_nbyte // 8, nfile=2)
    assert state["lapped"]
    assert len(files) == 2
    # the first file starts at the earliest frame after the lap: 11 - 4
    h, data = source.TriggerFileSource(files[0]).read()
    assert h["seq0"] == 7 * (frame_nbyte // 8)
    np.testing.assert_array_equal(data.reshape(-1), pushed[7])


def test_abort_before_trigger_does_not_cancel_it(tmp_path):
    """tests/test_control_robustness.py:113: an abort while idle does not
    latch and cancel the next trigger; an abort during a dump stops it."""
    ring = HistoryRing(8 * PCFG.gulp_nbyte, PCFG.gulp_nbyte)
    ring.set_header(source.sequence_header(PCFG, seq0=0), 0)
    rng = np.random.RandomState(2)
    for _ in range(4):
        ring.push(rng.randint(0, 256, PCFG.gulp_nbyte).astype(np.uint8))
    d = sink.TriggeredDump(ring, direct=False)
    d.abort()
    files = d.trigger(PCFG.ntime_gulp, nfile=1, dump_path=str(tmp_path))
    assert len(files) == 1
    orig = d._write_file

    def write_then_abort(*a):
        orig(*a)
        d.abort()

    d._write_file = write_then_abort
    files = d.trigger(PCFG.ntime_gulp, nfile=3, dump_path=str(tmp_path))
    assert len(files) == 1 and not d.abort_requested


def wait_idle(block, n_files, tmp_path, timeout_s=20.0):
    """Wait (bounded) for the dump thread: ``state`` idle and the files."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        files = sorted(glob.glob(str(tmp_path / "*.tbf")))
        if len(files) == n_files and block.stats.get("state") == "idle":
            return files
        time.sleep(0.02)
    raise AssertionError(f"dump not idle: {block.stats}, {files}")


def test_trigger_via_control_matches_jax_driver(tmp_path):
    """tests/test_triggered_dump_control.py: both drivers over the same
    ramp with a 16-gulp ring, a trigger of two one-gulp files through each
    package's client; the port's files equal the JAX driver's."""
    jst, pst = JStore(), MemoryStore()
    jpipe = jdriver.XEnginePipeline(
        CFG, jsource.DummySource(CFG, mode="ramp"), store=jst,
        history_nbyte=16 * CFG.gulp_nbyte, sync_time=SYNC)
    ppipe = driver.XEnginePipeline(
        PCFG, source.SyntheticSource(PCFG, mode="ramp"), store=pst,
        history_nbyte=16 * PCFG.gulp_nbyte, sync_time=SYNC, device="cpu")
    assert ppipe.history.nframe == jpipe.history.nframe == 16
    jpipe.run(12, timeout_s=180)
    ppipe.run(12, timeout_s=180)
    dirs = {k: tmp_path / k for k in "jp"}
    for d in dirs.values():
        d.mkdir()
    JPipelineControl(JClient(store=jst, timeout_s=5.0), HOST, 0) \
        .triggered_dump.trigger(ntime_per_file=CFG.ntime_gulp, nfile=2,
                                dump_path=str(dirs["j"]))
    PipelineControl(CorrControlClient(store=pst, timeout_s=5.0), HOST, 0) \
        .triggered_dump.trigger(ntime_per_file=PCFG.ntime_gulp, nfile=2,
                                dump_path=str(dirs["p"]))
    jfiles = wait_idle(jpipe.dump_cmd, 2, dirs["j"])
    pfiles = wait_idle(ppipe.dump_cmd, 2, dirs["p"])
    assert ppipe.dump_cmd.stats["last_files"] == pfiles
    for jf, pf in zip(jfiles, pfiles):
        assert Path(pf).name == Path(jf).name
        assert read_bytes(pf) == read_bytes(jf)
    hdr, data = source.TriggerFileSource(pfiles[0]).read()
    assert hdr["ntime"] == PCFG.ntime_gulp and hdr["seq0"] == 0
    want = source.SyntheticSource(PCFG, mode="ramp").gulp(0)
    np.testing.assert_array_equal(data, want)
    assert [s for s, _ in source.TriggerFileSource(pfiles[1]).gulps(
        PCFG.ntime_gulp)] == [PCFG.ntime_gulp]


def test_jax_client_triggers_the_port_driver(tmp_path):
    """The JAX package's operator client commands the port's recorder
    through one store: the command envelope is the same."""
    pst = MemoryStore()
    ppipe = driver.XEnginePipeline(
        PCFG, source.SyntheticSource(PCFG, mode="random"), store=pst,
        history_nbyte=8 * PCFG.gulp_nbyte, device="cpu")
    ppipe.run(6, timeout_s=180)
    resp = JPipelineControl(JClient(store=pst, timeout_s=5.0), HOST, 0) \
        .triggered_dump.trigger(ntime_per_file=2 * PCFG.ntime_gulp, nfile=1,
                                dump_path=str(tmp_path))
    assert resp["status"] == "normal"
    files = wait_idle(ppipe.dump_cmd, 1, tmp_path)
    h, data = source.TriggerFileSource(files[0]).read()
    # 6 gulps in an 8-frame ring: the file holds gulps 0 and 1
    want = source.SyntheticSource(PCFG, mode="random")
    np.testing.assert_array_equal(
        data, np.concatenate([want.gulp(0), want.gulp(1)]))


@pytest.mark.parametrize("adc_dtype", ["float32", "int8"])
def test_fx_dump_matches_jax_driver(tmp_path, adc_dtype):
    """tests/test_fx_driver.py:46,254: the FX ring holds raw ADC frames;
    the dump of the first gulp equals the JAX driver's file and replays to
    the ADC fed in."""
    jc = FX_CFG.replace(adc_dtype=adc_dtype)
    pc = TC.XEngineConfig(**dataclasses.asdict(jc))
    amp = 50.0 if adc_dtype == "int8" else 4.0
    nsamp = jc.ntime_gulp * 2 * jc.nchan
    nbyte = 8 * nsamp * jc.ninput * np.dtype(adc_dtype).itemsize
    jpipe = jdriver.XEnginePipeline(
        jc, jsource.ADCSource(jc, mode="tone", tone_chan=3, amplitude=amp),
        fx_mode=True, history_nbyte=nbyte, sync_time=SYNC)
    ppipe = driver.XEnginePipeline(
        pc, source.ADCSource(pc, mode="tone", tone_chan=3, amplitude=amp),
        fx_mode=True, history_nbyte=nbyte, sync_time=SYNC, device="cpu")
    jpipe.run(4, timeout_s=300)
    ppipe.run(4, timeout_s=300)
    (tmp_path / "j").mkdir()
    jf = jpipe.dumper.trigger(ntime_per_file=nsamp, nfile=2,
                              dump_path=str(tmp_path / "j"))
    pf = ppipe.dumper.trigger(ntime_per_file=nsamp, nfile=2,
                              dump_path=str(tmp_path))
    assert len(pf) == len(jf) == 2
    for a, b in zip(jf, pf):
        assert read_bytes(b) == read_bytes(a)
    hdr, data = source.TriggerFileSource(pf[1]).read()
    assert hdr["adc"] and hdr["seq0"] == pc.ntime_gulp
    assert data.dtype == np.dtype(adc_dtype)
    want = source.ADCSource(pc, mode="tone", tone_chan=3,
                            amplitude=amp).gulp(1)
    np.testing.assert_array_equal(data, want)


def test_build_pipeline_from_json():
    """``build_pipeline_from_json`` gives a running pipeline on a
    synthetic source, with the history ring when asked."""
    blob = json.dumps({"config": {"nstand": 16, "nchan": 16, "nbeam": 4,
                                  "ntime_gulp": 48, "acc_len": 240,
                                  "acc_len_slow": 480},
                       "source": {"mode": "random", "seed": 9}})
    pipe = driver.build_pipeline_from_json(blob, device="cpu",
                                           history_nbyte=1 << 20)
    jpipe = jdriver.build_pipeline_from_json(blob, history_nbyte=1 << 20)
    assert pipe.cfg == TC.XEngineConfig(**dataclasses.asdict(jpipe.cfg))
    assert pipe.history.nframe == jpipe.history.nframe
    pipe.run(10, timeout_s=120)
    assert (pipe.ndump_fast, pipe.ndump_slow) == (2, 1)
    assert pipe.history.count == 10
