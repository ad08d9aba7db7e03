"""The port's product sinks against ``caltech_bifrost_dsp_tpu/io/sink.py``:
each sink is fed the same products as its JAX counterpart and the packets
it passes to ``send`` must be byte-identical; the golden checkfile gate
must agree; the UDP sender reaches a loopback receiver."""

import dataclasses
import time

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.io import sink as jsink
from caltech_bifrost_dsp_tpu.verification import golden as jgolden
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.io import sink

CONFIGS = {"tiny": C.TINY.replace(pipeline_id=1, npipeline=4),
           "ragged": C.TINY.replace(nstand=36, nchan=8, pipeline_id=3,
                                    npipeline=4)}


def port_cfg(jcfg):
    """The port's config from the JAX one, field by field."""
    return TC.XEngineConfig(**dataclasses.asdict(jcfg))


def planes(cfg, seed):
    """Hermitian int32 planes [nchan, ninput, ninput] and their complex128
    dense matrix."""
    rng = np.random.RandomState(seed)
    n = cfg.ninput
    a = rng.randint(-2 ** 20, 2 ** 20, (cfg.nchan, n, n))
    b = rng.randint(-2 ** 20, 2 ** 20, (cfg.nchan, n, n))
    vr = (a + a.transpose(0, 2, 1)).astype(np.int32)
    vi = (b - b.transpose(0, 2, 1)).astype(np.int32)
    return vr, vi, vr.astype(np.complex128) + 1j * vi


@pytest.mark.parametrize("cor_fmt", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_corr_full_packets_match_jax(name, cor_fmt):
    cfg = CONFIGS[name]
    vr, vi, dense = planes(cfg, 1)
    got, got_dense, want = [], [], []
    args = (1_700_000_123, 7 * cfg.acc_len_slow, cfg.acc_len_slow)
    n = sink.CorrFullOutput(port_cfg(cfg), send=got.append, use_cor_fmt=cor_fmt) \
        .send_matrix_planes(vr, vi, *args)
    sink.CorrFullOutput(port_cfg(cfg), send=got_dense.append,
                        use_cor_fmt=cor_fmt).send_matrix(dense, *args)
    jsink.CorrFullOutput(cfg, send=want.append,
                         use_cor_fmt=cor_fmt).send_matrix(dense, *args)
    assert n == len(want) == cfg.nstand * (cfg.nstand + 1) // 2
    assert got == want and got_dense == want
    if cor_fmt:
        cube = pk.cor_scatter_matrix(got, cfg.nstand)
        v5 = vr.reshape(cfg.nchan, cfg.nstand, 2, cfg.nstand, 2)
        np.testing.assert_array_equal(cube[..., 0],
                                      v5.transpose(1, 3, 2, 4, 0))


def test_corr_full_without_destination_sends_nothing():
    cfg = CONFIGS["tiny"]
    vr, vi, _ = planes(cfg, 2)
    assert sink.CorrFullOutput(port_cfg(cfg)).send_matrix_planes(vr, vi, 0, 0, 1) == 0


@pytest.mark.parametrize("nrep,t_index", [(1, 0), (1, 3), (2, 1)])
def test_checkfile_gate_matches_jax(tmp_path, nrep, t_index):
    """The gate integrates ``nrep`` golden blocks from ``t_index * nrep``,
    looping the file; a corrupted matrix fails it in both packages."""
    cfg = C.TINY
    ntime = 2 * cfg.acc_len
    path = str(tmp_path / "corr.dat")
    jgolden.write_corr_file(path, ntime, cfg.nchan, cfg.nstand, cfg.npol,
                            cfg.acc_len)
    jout = jsink.CorrFullOutput(cfg, checkfile=path,
                                checkfile_acc_len=cfg.acc_len)
    out = sink.CorrFullOutput(port_cfg(cfg), checkfile=path,
                              checkfile_acc_len=cfg.acc_len)
    want = sum(jout._load_checkfile_corr(t_index * nrep + i)
               for i in range(nrep))
    dense = want.transpose(0, 1, 3, 2, 4).reshape(cfg.nchan, cfg.ninput,
                                                  cfg.ninput)
    vr, vi = dense.real.astype(np.int32), dense.imag.astype(np.int32)
    acc = nrep * cfg.acc_len
    assert out.check_against_file(vr, vi, acc, t_index)
    assert jout.check_against_file(dense, acc, t_index)
    vi[0, 0, 1] += 1
    assert not out.check_against_file(vr, vi, acc, t_index)
    assert not jout.check_against_file(vr + 1j * vi, acc, t_index)
    assert (out.check_count, out.check_failures) == (2, 1)
    with pytest.raises(ValueError):
        out.check_against_file(vr, vi, cfg.acc_len + 1, 0)


@pytest.mark.parametrize("nvis_per_packet", [16, 7])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_corr_part_packets_match_jax(name, nvis_per_packet):
    cfg = CONFIGS[name]
    rng = np.random.RandomState(3)
    nco = cfg.nchan // cfg.nchan_sum
    sr = rng.randint(-9999, 9999, (nco, cfg.nvis_out)).astype(np.int32)
    si = rng.randint(-9999, 9999, (nco, cfg.nvis_out)).astype(np.int32)
    bl = rng.randint(0, cfg.nstand, (cfg.nvis_out, 2, 2)).astype(np.uint32)
    args = (sr, si, bl, 1_700_000_000, 5 * cfg.acc_len, cfg.acc_len)
    got, want = [], []
    sink.CorrPartOutput(port_cfg(cfg), send=got.append,
                        nvis_per_packet=nvis_per_packet).send_subsel(*args)
    jsink.CorrPartOutput(cfg, send=want.append,
                         nvis_per_packet=nvis_per_packet).send_subsel(*args)
    assert got == want and len(got) == -(-cfg.nvis_out // nvis_per_packet)


@pytest.mark.parametrize("with_map", [True, False])
def test_corr_part_cor_packets_match_jax(with_map):
    cfg = CONFIGS["tiny"]
    rng = np.random.RandomState(4)
    nco = cfg.nchan // cfg.nchan_sum
    sr = rng.randint(-9999, 9999, (nco, cfg.nvis_out)).astype(np.int32)
    si = rng.randint(-9999, 9999, (nco, cfg.nvis_out)).astype(np.int32)
    bl = rng.randint(0, cfg.nstand, (cfg.nvis_out, 2, 2)).astype(np.uint32)
    bl = bl if with_map else None
    got, want = [], []
    sink.CorrPartOutput(port_cfg(cfg), send=got.append, use_cor_fmt=True) \
        ._send_subsel_cor(sr, si, bl, 480, 240, 1_700_000_000)
    jsink.CorrPartOutput(cfg, send=want.append, use_cor_fmt=True) \
        ._send_subsel_cor(sr, si, bl, 480, 240, 1_700_000_000)
    assert got == want and len(got) == cfg.nvis_out // 4


def test_beam_packets_match_jax():
    cfg = CONFIGS["ragged"]
    rng = np.random.RandomState(5)
    power = rng.randn(cfg.nbeam // 2, 4, cfg.nchan, 4).astype(np.float32)
    vlbi = rng.randn(cfg.ntime_gulp, cfg.nchan, 2, 2).astype(np.float32)
    got, want = {0: [], 1: []}, {0: [], 1: []}
    n = sink.PBeamOutput(port_cfg(cfg), senders={b: got[b].append for b in got},
                         pipeline_idx=2).send_powers(power, 960, 24)
    jsink.PBeamOutput(cfg, senders={b: want[b].append for b in want},
                      pipeline_idx=2).send_powers(power, 960, 24)
    assert got == want and n == 8
    got_v, want_v = [], []
    assert sink.IBeamOutput(port_cfg(cfg), send=got_v.append, pipeline_idx=2) \
        .send_voltages(vlbi, 960) == cfg.ntime_gulp
    jsink.IBeamOutput(cfg, send=want_v.append, pipeline_idx=2) \
        .send_voltages(vlbi, 960)
    assert got_v == want_v
    assert sink.IBeamOutput(port_cfg(cfg)).send_voltages(vlbi, 0) == 0


def test_throttle_holds_the_rate():
    """8 blocks of 80 kbit at 8 Mb/s take at least 70 ms (the first block
    starts the clock)."""
    th = sink.Throttle(8e6, block_bits=80_000)
    t0 = time.monotonic()
    for _ in range(80):
        th.account(8_000)
    assert time.monotonic() - t0 >= 0.07
    t0 = time.monotonic()
    free = sink.Throttle(None)
    for _ in range(1000):
        free.account(8_000_000)
    assert time.monotonic() - t0 < 0.5


def test_udp_sender_reaches_loopback_receiver():
    rx = sink.udp_rx_socket("127.0.0.1", 0, rcvbuf_mb=1, timeout_s=5.0)
    try:
        tx = sink.UdpSender("127.0.0.1", rx.getsockname()[1])
        payload = bytes(range(256)) * 20
        tx(payload)
        assert rx.recv(65536) == payload
        tx.sock.close()
    finally:
        rx.close()


def test_max_mbps_sets_the_sink_throttle():
    cfg = CONFIGS["tiny"]
    assert sink.CorrFullOutput(port_cfg(cfg), max_mbps=1500).throttle.max_bps == 1.5e9
    assert sink.CorrFullOutput(port_cfg(cfg)).throttle.max_bps is None
    assert sink.CorrPartOutput(port_cfg(cfg), max_mbps=20).throttle.max_bps == 2e7
    assert sink.IBeamOutput(port_cfg(cfg)).throttle.max_bps == \
        jsink.IBeamOutput.MAX_BPS
