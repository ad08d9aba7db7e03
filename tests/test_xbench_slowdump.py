"""The benchmark's slow-dump cell ``xb-slowdump`` on the CPU: a whole run
at the small shape in a process of its own; the COR judge against
packets the port's ``CorrFullOutput`` encoded from an independent numpy
correlation, and against each fault it must count; the COR decoder
against the port's encoder; the comparison's control, which the
harness's ``--control`` refuses."""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as pconfig
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink as psink
from xbench import spec
from xbench.cell import sizes
from xbench.reference import check
from xbench.reference import cor
from xbench.sinks import cor_full as cor_sink
from xbench.tests.small import SMALL
from xbench.traffic.pool import make_pool

ROOT = Path(__file__).resolve().parents[1]
CELL = "xb-slowdump"
SEED = 2 ** 31 + 29

DRY = """
import json, sys
from xbench import spec
from xbench.cell import run_cell
from xbench.run import forbidden_modules
from xbench.tests.small import SMALL
out = run_cell(spec.cell(sys.argv[1]), 2 ** 31 + 17, 1.5,
               bool(int(sys.argv[2])), device="cpu", override=SMALL,
               log=lambda s: None)
out["forbidden"] = forbidden_modules()
print(json.dumps(out))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_on_the_cpu(trace):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", DRY, CELL, str(trace)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert out["correct"] is True and out["failed"] == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-2] == "checks"
    ch = out["checks"]
    assert set(ch) == {"vis_mismatch", "packets_bad", "cor_mismatch",
                       "windows_unchecked"}
    assert all(v["value"] == 0 for v in ch.values())
    # the accumulators and at least two whole slow dumps judged
    assert out["attempted"] >= 4
    w = spec.workload(CELL)
    if trace:
        # the metrics read on the host's side are there on the CPU too;
        # the correlator's roofline needs the card's kernels
        m = out["metrics"]
        assert set(m) <= set(w["per_layer"])
        assert m["served_realtime_factor"]["value"] > 0
        assert m["sink_s_per_window"]["value"] > 0
    else:
        assert list(out["metrics"]) == w["end_to_end"]


# -- the judge ---------------------------------------------------------------


def small_cfg(**kw):
    conf = spec.config("lwa352-xb-cor")
    xe = dict(conf["xengine"], **{**SMALL, **kw})
    xe.update(pconfig.TPU_ENGINES)
    return conf, pconfig.XEngineConfig(**xe)


def reference(conf, cfg):
    p = sizes(conf, cfg)
    pool = make_pool(15, (cfg.ntime_gulp, cfg.nchan, cfg.ninput), "packed",
                     SEED, "cpu")
    inputs = check.Inputs("packed", p, pool, "cpu")
    return check.Reference(p, conf, inputs, {}, "cpu", False), pool


def numpy_period(cfg, pool, w):
    """The slow period starting at window ``w``, correlated in numpy:
    int32 planes [nchan, ninput, ninput] of sum_t x_a conj(x_b)."""
    gpw = cfg.acc_len // cfg.ntime_gulp
    per = cfg.acc_len_slow // cfg.acc_len
    x = np.concatenate([pool[n % len(pool)]
                        for n in range(w * gpw, (w + per) * gpw)])
    re = x.astype(np.int8) >> 4
    im = (x << 4).astype(np.int8) >> 4
    z = (re + 1j * im).transpose(1, 2, 0)          # [c, i, t]
    v = z @ z.conj().transpose(0, 2, 1)
    return (np.rint(v.real).astype(np.int32),
            np.rint(v.imag).astype(np.int32))


@pytest.fixture(scope="module")
def dump():
    """(reference, window, packets of the second slow dump at SMALL)."""
    conf, cfg = small_cfg()
    ref, pool = reference(conf, cfg)
    w = cfg.acc_len_slow // cfg.acc_len
    pkts: list = []
    psink.CorrFullOutput(cfg, send=pkts.append, use_cor_fmt=True) \
        .send_matrix_planes(*numpy_period(cfg, pool, w), 0,
                            w * cfg.acc_len, cfg.acc_len_slow)
    return ref, w, pkts


def judged(ref, pkts):
    """(good, bad, cor_mismatch) over the windows the packets name, as
    ``check.compare`` groups them."""
    win: dict = {}
    for pkt in pkts:
        seq, rec = cor_sink.decode_packet(pkt)
        win.setdefault(seq // ref.p["acc_len"], []).append(rec)
    good = bad = mis = 0
    for w, recs in win.items():
        g, b, nums = cor_sink.judge(w, recs, ref)
        good, bad, mis = good + g, bad + b, mis + nums["cor_mismatch"]
    return good, bad, mis


def header(pkt: bytes, fmt: str, off: int, value) -> bytes:
    b = bytearray(pkt)
    struct.pack_into(fmt, b, off, value)
    return bytes(b)


def test_a_sound_dump_passes(dump):
    ref, w, pkts = dump
    nstand = ref.p["nstand"]
    assert len(pkts) == nstand * (nstand + 1) // 2
    assert judged(ref, pkts) == (len(pkts), 0, 0)


def test_a_flipped_value_is_counted(dump):
    ref, w, pkts = dump
    b = bytearray(pkts[5])
    b[32 + 4 * 37 + 3] ^= 0x01                    # one int32 of the payload
    assert judged(ref, pkts[:5] + [bytes(b)] + pkts[6:]) == (
        len(pkts), 0, 1)


def test_a_dropped_packet_is_counted(dump):
    ref, w, pkts = dump
    assert judged(ref, pkts[:7] + pkts[8:]) == (len(pkts) - 1, 1, 0)


def test_a_duplicated_packet_is_counted(dump):
    ref, w, pkts = dump
    assert judged(ref, pkts + [pkts[7]]) == (len(pkts), 1, 0)


def test_a_wrong_stand_j_is_counted(dump):
    """Packet (i, j) labelled (i, j + 1): it takes that pair's place with
    the wrong values, the true (i, j + 1) is a duplicate, and (i, j) is
    missing."""
    ref, w, pkts = dump
    k = 3
    hi, hj = struct.unpack_from(">HH", pkts[k], 28)
    bad = header(pkts[k], ">H", 30, hj + 1)
    a = np.frombuffer(pkts[k], ">i4", offset=32)
    b = np.frombuffer(pkts[k + 1], ">i4", offset=32)
    assert struct.unpack_from(">HH", pkts[k + 1], 28) == (hi, hj + 1)
    assert judged(ref, pkts[:k] + [bad] + pkts[k + 1:]) == (
        len(pkts) - 1, 2, int((a != b).sum()))


@pytest.mark.parametrize("shift", ["sample", "window"])
def test_a_wrong_time_tag_is_counted(dump, shift):
    """A time tag one ADC sample late stays in its dump with a wrong
    header; one fast window late it lands where no dump starts.  Either
    way the packet is bad and its pair missing."""
    ref, w, pkts = dump
    tt, = struct.unpack_from(">Q", pkts[9], 16)
    step = 1 if shift == "sample" else (ref.p["acc_len"]
                                        * cor.SAMPLES_PER_SPECTRUM)
    bad = header(pkts[9], ">Q", 16, tt + step)
    assert judged(ref, pkts[:9] + [bad] + pkts[10:]) == (
        len(pkts) - 1, 2, 0)


@pytest.mark.parametrize("field,fmt,off", [("navg", ">I", 24),
                                            ("freq", ">H", 12),
                                            ("frame", ">I", 4)])
def test_a_wrong_header_field_is_counted(dump, field, fmt, off):
    ref, w, pkts = dump
    v, = struct.unpack_from(fmt, pkts[2], off)
    bad = header(pkts[2], fmt, off, v + 1)
    assert judged(ref, pkts[:2] + [bad] + pkts[3:]) == (len(pkts) - 1, 2, 0)


def test_a_packet_that_does_not_decode_is_refused(dump):
    ref, w, pkts = dump
    with pytest.raises(ValueError):
        cor_sink.decode_packet(header(pkts[0], ">I", 0, 0xDEC0DE5D))
    with pytest.raises(ValueError):
        cor_sink.decode_packet(pkts[0][:-4])


# -- the decoder against the port's encoder ----------------------------------


@pytest.mark.parametrize("pipeline_id,w", [(0, 0), (3, 200), (33, 7)])
def test_decoder_reads_the_port_encoder(pipeline_id, w):
    conf, cfg = small_cfg(nstand=12, nchan=8, pipeline_id=pipeline_id,
                          npipeline=32)
    p = sizes(conf, cfg)
    rng = np.random.default_rng(pipeline_id + 1)
    shape = (cfg.nchan, cfg.ninput, cfg.ninput)
    re, im = (rng.integers(-2 ** 31, 2 ** 31, shape, np.int64).astype(
        np.int32) for _ in range(2))
    pkts: list = []
    n = psink.CorrFullOutput(cfg, send=pkts.append, use_cor_fmt=True) \
        .send_matrix_planes(re, im, 0, w * cfg.acc_len, cfg.acc_len_slow)
    assert n == len(pkts) == cfg.nstand * (cfg.nstand + 1) // 2
    want = cor.expected_header(p, w)
    row = cor.pair_rows(cfg.nstand)
    for pkt in pkts:
        h, data = cor.decode(pkt)
        ph, pdata = pk.decode_cor(pkt)
        assert {k: h[k] for k in want} == want
        assert (h["frame"], h["secs"], h["freq"], h["gain"], h["time_tag"],
                h["navg"], h["stand_i"], h["stand_j"]) == (
            ph.frame_number, ph.secs_count, ph.freq_count, ph.cor_gain,
            ph.time_tag, ph.cor_navg, ph.stand_i, ph.stand_j)
        i, j = h["stand_i"] - 1, h["stand_j"] - 1
        assert row[i, j] >= 0
        for p0 in range(2):
            for p1 in range(2):
                a, b = 2 * i + p0, 2 * j + p1
                assert np.array_equal(data[:, p0, p1, 0], re[:, a, b])
                assert np.array_equal(data[:, p0, p1, 1], im[:, a, b])
        np.testing.assert_array_equal(data, pdata)
    assert cor_sink.decode_packet(pkts[0])[0] == w * cfg.acc_len


# -- the control -------------------------------------------------------------


def test_the_control_fails_in_float16_and_not_in_float32(dump):
    """float32 holds every sum of this traffic exactly (all below 2^24),
    so the limit's lower reading is float16's, which rounds every value
    past its 11-bit significand (and overflows past 65504)."""
    ref, w, pkts = dump
    assert cor.control_mismatch(ref, w, torch.float32) == 0
    assert cor.control_mismatch(ref, w, torch.float16) > 0


def test_the_harness_control_refuses_the_cell():
    """The harness's ``--control`` runs no control through the COR judge,
    so it refuses this cell rather than report the ordinary comparison."""
    from xbench.cell import run_cell

    with pytest.raises(KeyError, match="control"):
        run_cell(spec.cell(CELL), SEED, 1.0, False, device="cpu",
                 control=True, override=SMALL, log=lambda s: None)
