"""The ``write_autos`` output command through the port and through the JAX
package: the same dump writes byte-equal ``autos_<spectra_id>.npy`` files.

Three levels, each against its JAX counterpart: ``autocorr_spectra``; the
``CorrOutputFull`` command block with a sink fed one dense matrix (complex
and int32 planes); and the whole driver on the CPU over the same stream,
the command sent through the control store before the run, then turned
off with the empty string.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.control.store import MemoryStore as JStore
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.ops import correlate as jcorr
from caltech_bifrost_dsp_tpu.runtime import driver as jdriver
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.control.store import MemoryStore
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.ops import correlate
from caltech_bifrost_dsp_tpu_torch.runtime import driver
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)

CFG = C.TINY
PCFG = TC.XEngineConfig(**dataclasses.asdict(CFG))


@pytest.fixture(autouse=True)
def _fresh_port_registry():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


def command(store, key, seq, **kwargs):
    store.put(key, json.dumps({"cmd": "update", "id": seq,
                               "val": {"kwargs": kwargs}}))


def dense_matrix(cfg, seed):
    rng = np.random.RandomState(seed)
    v = (rng.randint(-5, 5, [5, cfg.nchan, cfg.ninput])
         + 1j * rng.randint(-5, 5, [5, cfg.nchan, cfg.ninput]))
    return np.einsum("tci,tcj->cij", v, v.conj())


@pytest.mark.parametrize("nstand,npol,nchan", [(4, 2, 6), (3, 1, 5)])
def test_autocorr_spectra_matches_jax(nstand, npol, nchan):
    rng = np.random.RandomState(nstand)
    nin = nstand * npol
    dense = (rng.randint(-99, 99, (nchan, nin, nin))
             + 1j * rng.randint(-99, 99, (nchan, nin, nin)))
    want = jcorr.autocorr_spectra(dense, nstand, npol)
    got = correlate.autocorr_spectra(dense, nstand, npol)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the real int32 plane alone gives the same spectra
    np.testing.assert_array_equal(
        correlate.autocorr_spectra(dense.real.astype(np.int32), nstand,
                                   npol), want)


@pytest.mark.parametrize("planes", [False, True])
def test_write_autos_command_writes_the_jax_file(tmp_path, planes):
    """The shapes of tests/test_output_control.py::test_write_autos_control
    through both packages' command block and sink."""
    dense = dense_matrix(CFG, 0)
    files = {}
    for name, smod, dmod, store, cfg in (
            ("jax", jsink, jdriver, JStore(), CFG),
            ("port", sink, driver, MemoryStore(), PCFG)):
        pkts = []
        out = smod.CorrFullOutput(cfg, send=pkts.append)
        blk = dmod.OutputCommandBlock("CorrOutputFull", out, store=store)
        assert out.autos_path is None
        where = tmp_path / name
        where.mkdir()
        command(store, blk.command_key, "1", write_autos=str(where))
        blk.apply_pending()
        assert out.autos_path == str(where)
        if planes and name == "port":
            out.send_matrix_planes(dense.real.astype(np.int32),
                                   dense.imag.astype(np.int32), 0, 480, 480)
        else:
            out.send_matrix(dense, sync_time=0, spectra_id=480, acc_len=480)
        files[name] = (where / "autos_480.npy").read_bytes()
        # the empty string turns it off again
        command(store, blk.command_key, "2", write_autos="")
        blk.apply_pending()
        assert out.autos_path is None
        out.send_matrix(dense, sync_time=0, spectra_id=960, acc_len=480)
        assert not (where / "autos_960.npy").exists()
    assert files["port"] == files["jax"]
    autos = np.load(tmp_path / "port" / "autos_480.npy")
    assert autos.shape == (CFG.nstand, CFG.npol, CFG.nchan)
    np.testing.assert_array_equal(autos[0, 0], np.real(dense[:, 0, 0]))


def test_sinks_without_autos_path_have_no_write_autos_key():
    out = sink.CorrPartOutput(PCFG, send=None)
    blk = driver.OutputCommandBlock("CorrOutputPart", out,
                                    store=MemoryStore())
    assert "write_autos" not in blk.command_vals
    full = driver.OutputCommandBlock(
        "CorrOutputFull", sink.CorrFullOutput(PCFG, send=None),
        store=MemoryStore())
    assert full.command_vals["write_autos"] == ""


def test_write_autos_through_both_drivers(tmp_path):
    """The shapes of tests/test_driver.py::
    test_write_autos_through_pipeline_control: every slow dump of both
    drivers over the same stream writes the same file."""
    ngulp = 2 * CFG.acc_len_slow // CFG.ntime_gulp
    listing = {}
    for name, pipe_cls, smod, src_cls, store, cfg, kw in (
            ("jax", jdriver.XEnginePipeline, jsink, jsource.DummySource,
             JStore(), CFG, {}),
            ("port", driver.XEnginePipeline, sink, source.SyntheticSource,
             MemoryStore(), PCFG, {"device": "cpu"})):
        where = tmp_path / name
        where.mkdir()
        out = smod.CorrFullOutput(cfg, send=None)
        pipe = pipe_cls(cfg, src_cls(cfg, mode="random", seed=11),
                        store=store, corr_outputs=[out], **kw)
        blk = next(b for b in pipe.output_cmds if b.sink is out)
        command(store, blk.command_key, "1", write_autos=str(where))
        pipe.run(ngulp, timeout_s=180)
        assert pipe.ndump_slow == 2
        listing[name] = {f.name: f.read_bytes()
                         for f in sorted(where.iterdir())}
    assert len(listing["port"]) == 2
    assert listing["port"] == listing["jax"]
    for raw_name in listing["port"]:
        autos = np.load(tmp_path / "port" / raw_name)
        assert autos.shape == (CFG.nstand, CFG.npol, CFG.nchan)
        assert (autos >= 0).all() and autos.sum() > 0
