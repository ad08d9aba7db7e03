"""The port's measuring entry points on the CPU, beside the JAX package:
the source's ``skip_write`` (bytes equal to the JAX ``DummySource``'s,
recycled staging slots included), the plain functions the benches call
(``long_accumulate``, ``vis_to_numpy_complex``, the complex-dtype PFB and
requantizer), ``utils/roofline.py`` against the Bound column of
``PERF.md`` section 6, ``bench_pipeline --stub-device`` (plain, over UDP,
FX over UDP) with the JAX script's JSON keys, ``bench_scaling --cpu 4``
with ``collective_volumes`` equal to the JAX module's, ``bench_ingest``'s
engines over loopback, and the device benches refusing a host without a
card.  Every UDP port comes from binding port 0."""

import dataclasses
import gc
import json
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu import config as jconfig
from caltech_bifrost_dsp_tpu.io import source as jsource
from caltech_bifrost_dsp_tpu.ops import correlate as jcorr
from caltech_bifrost_dsp_tpu.ops import pfb as jpfb
from caltech_bifrost_dsp_tpu.parallel import mesh as jmesh
from caltech_bifrost_dsp_tpu.scripts import bench_pipeline as jbench_pipeline
from caltech_bifrost_dsp_tpu_torch import config as tconfig
from caltech_bifrost_dsp_tpu_torch.io import source as tsource
from caltech_bifrost_dsp_tpu_torch.ops import correlate as tcorr
from caltech_bifrost_dsp_tpu_torch.ops import pfb as tpfb
from caltech_bifrost_dsp_tpu_torch.scripts import (bench_ingest,
                                                   bench_pipeline,
                                                   bench_scaling,
                                                   bench_stages, bench_step)
from caltech_bifrost_dsp_tpu_torch.utils import roofline as rl

torch.set_num_threads(1)

JCFG = jconfig.XEngineConfig(nstand=16, nchan=32, ntime_gulp=48,
                             acc_len=240, acc_len_slow=480, nbeam=4,
                             ntime_sum=12, npipeline=2)
CFG = tconfig.XEngineConfig(**dataclasses.asdict(JCFG))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# -- skip_write ---------------------------------------------------------------


def test_skip_write_gulps_match_jax():
    """``gulp()`` gives zeros in every mode, as the JAX source does."""
    for mode in ("ramp", "random"):
        j = jsource.DummySource(JCFG, mode=mode, skip_write=True)
        t = tsource.SyntheticSource(CFG, mode=mode, skip_write=True)
        for i in range(3):
            a, b = j.gulp(i), t.gulp(i)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            assert not b.any()


def test_skip_write_fill_into_matches_jax():
    """``fill_into`` zeros a staging slot the first time, skips the memset
    on a slot it zeroed before (bytes written there since stay, in both
    packages), and zeros a slot of a rebuilt buffer at a recycled address
    again; it returns the same sequence numbers as the JAX source."""
    n = CFG.gulp_nbyte
    j = jsource.DummySource(JCFG, skip_write=True)
    t = tsource.SyntheticSource(CFG, skip_write=True)

    def both(backing_j, backing_t, off):
        sj = j.fill_into(backing_j[off:off + n])
        st = t.fill_into(backing_t[off:off + n])
        assert sj == st
        np.testing.assert_array_equal(backing_j, backing_t)

    bj, bt = (np.full(3 * n, 0xAB, np.uint8) for _ in range(2))
    both(bj, bt, 0)
    both(bj, bt, n)
    assert not bt[:2 * n].any() and (bt[2 * n:] == 0xAB).all()
    # a recycled slot known to hold only zeros: no memset
    bj[:8] = bt[:8] = 7
    both(bj, bt, 0)
    assert (bt[:8] == 7).all()
    # the ring rebuilt: a new buffer, possibly at the same address, is
    # never trusted
    del bj, bt
    gc.collect()
    bj, bt = (np.full(3 * n, 0xCD, np.uint8) for _ in range(2))
    both(bj, bt, 0)
    assert not bt[:n].any()


def test_skip_write_source_feeds_the_stub_driver():
    """``bench_pipeline``'s pairing: the skip-write source in place in the
    staging ring under the stub device, every gulp taken."""
    from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline

    cfg = CFG
    pipe = XEnginePipeline(cfg, tsource.SyntheticSource(cfg,
                                                        skip_write=True),
                           stub_device_ms=0.1, device="cpu")
    pipe.run(20, timeout_s=120)
    assert (pipe.ndump_fast, pipe.ndump_slow) == (4, 2)
    assert not pipe.staging._backing.any()


# -- plain functions against JAX ---------------------------------------------


def test_long_accumulate_and_complex_view_match_jax():
    rng = np.random.RandomState(3)
    planes = [rng.randint(-1 << 20, 1 << 20, (4, 6, 6)).astype(np.int32)
              for _ in range(4)]
    jv = jcorr.long_accumulate(jcorr.Vis(*map(jnp.asarray, planes[:2])),
                               jcorr.Vis(*map(jnp.asarray, planes[2:])))
    tv = tcorr.long_accumulate(tcorr.Vis(*map(torch.from_numpy, planes[:2])),
                               tcorr.Vis(*map(torch.from_numpy, planes[2:])))
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jc = jcorr.vis_to_numpy_complex(jv)
    tc = tcorr.vis_to_numpy_complex(tv)
    assert tc.dtype == jc.dtype == np.complex128
    np.testing.assert_array_equal(tc, jc)


NCHAN, NTAP, NSPEC = 16, 4, 10


def adc_block(ninput=6, seed=5) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return (rng.standard_normal([(NSPEC + NTAP - 1) * 2 * NCHAN, ninput])
            * 3).astype(np.float32)


@pytest.mark.parametrize("fft_impl", ["fft", "matmul"])
def test_pfb_channelize_matches_jax(fft_impl):
    """complex64 [nspec, nchan, ninput] within 1e-5 x max|JAX| (the JAX
    float32 FFT, or its float32 DFT matrix products at HIGH precision,
    beside the port's float64 transform), trailing axes carried."""
    x = adc_block()
    w = jpfb.pfb_window(NCHAN, NTAP)
    want = np.asarray(jpfb.pfb_channelize(jnp.asarray(x), jnp.asarray(w),
                                          NCHAN, NTAP, fft_impl))
    got = tpfb.pfb_channelize(torch.from_numpy(x), w, NCHAN, NTAP,
                              fft_impl).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    x3 = x.reshape(x.shape[0], 2, 3)
    want3 = np.asarray(jpfb.pfb_channelize(jnp.asarray(x3), jnp.asarray(w),
                                           NCHAN, NTAP, fft_impl))
    got3 = tpfb.pfb_channelize(torch.from_numpy(x3), w, NCHAN, NTAP,
                               fft_impl).numpy()
    assert got3.shape == want3.shape
    np.testing.assert_allclose(got3, want3, rtol=0,
                               atol=1e-5 * np.abs(want3).max())


def test_pfb_channelize_planes_matches_jax():
    """float32 (re, im) planes within 1e-5 x max|JAX| (the JAX matrix
    products at HIGH precision beside float64)."""
    x = adc_block()
    w = jpfb.pfb_window(NCHAN, NTAP)
    want = [np.asarray(p) for p in jpfb.pfb_channelize_planes(
        jnp.asarray(x), jnp.asarray(w), NCHAN, NTAP)]
    got = [p.numpy() for p in tpfb.pfb_channelize_planes(
        torch.from_numpy(x), w, NCHAN, NTAP)]
    scale = max(np.abs(p).max() for p in want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_4bit_matches_jax(per_channel):
    """Packed bytes exactly equal, ties included (round half to even in
    float32), scalar and per-channel scale, planes and complex input."""
    rng = np.random.RandomState(7)
    shape = (5, NCHAN, 6)
    re = (rng.randint(-40, 41, shape) / 4).astype(np.float32)
    im = (rng.standard_normal(shape) * 6).astype(np.float32)
    scale = ((rng.rand(NCHAN) + 0.5).astype(np.float32) if per_channel
             else 0.75)
    want = np.asarray(jpfb.quantize_4bit_planes(jnp.asarray(re),
                                                jnp.asarray(im), scale))
    got = tpfb.quantize_4bit_planes(torch.from_numpy(re),
                                    torch.from_numpy(im), scale).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    z = re + 1j * im
    want_z = np.asarray(jpfb.quantize_4bit(jnp.asarray(z.astype(
        np.complex64)), scale))
    got_z = tpfb.quantize_4bit(torch.from_numpy(z.astype(np.complex64)),
                               scale).numpy()
    np.testing.assert_array_equal(got_z, want_z)


# -- the yardstick ------------------------------------------------------------

L352 = tconfig.LWA352
T, C, I = L352.acc_len, L352.nchan, L352.ninput

#: PERF.md section 6, "Bound ms": row -> (work, bound in ms to 3 decimals)
BOUND_ROWS = {
    1: (rl.corr_work(C, T, I, 64, 4, 4), 0.593),
    2: (rl.beamform_work(C, T, I, L352.nbeam, L352.ntime_sum), 0.111),
    3: (rl.subsel_work(L352.nvis_out + 1, C, L352.nchan_sum), 0.003),
    6: (rl.corr_work(C, T, I, 128, 0, 2), 0.462),
    7: (rl.corr_work(C, T, I, 64, 4, 4), 0.593),
    8: (rl.corr_work(C, T, I, 128, 0, 2), 0.462),
    9: (rl.corr_work(C, T, I, 128, 0, 2), 0.462),
    10: (rl.pfb_work((T + 3) * 2 * C * I, I, T, C, 4), 0.291),
    11: (rl.pfb_work((240 + 3) * 8192 * I, I, 240, 4096, 4), 0.837),
}


@pytest.mark.parametrize("row", sorted(BOUND_ROWS))
def test_roofline_reproduces_the_bound_column(row):
    work, want = BOUND_ROWS[row]
    assert round(rl.bound(*work)["bound_ms"], 3) == want


def test_bench_stages_models_are_the_kernel_rows():
    """The stages that run a kernel of the table are held to its row's
    bound (to 3 decimals: row 3 has one malformed pair more than the
    production selection); the plain stages' models bind where their
    docstring says."""
    models = bench_stages.stage_models(L352, L352.nvis_out, L352.nvis_out)
    for stage, row in (("corr_blk_acc", 7), ("beamform_fused", 2),
                       ("pfb_fused_bf16_int8", 10), ("pfb_fft_high_int8", 10),
                       ("subsel_bands", 3)):
        assert round(rl.bound(*models[stage])["bound_ms"], 3) == \
            BOUND_ROWS[row][1]
    assert set(models) == {
        "pfb_fused_bf16", "pfb_fused_high", "pfb_fused_bf16_int8",
        "pfb_fft_high_int8", "corr_window", "beamform_power", "subsel", "subsel_pallas",
        "subsel_bands", "slow_accum", "corr_blk_acc", "beamform_fused"}
    assert models["corr_window"][2] == models["beamform_power"][2] == "fp64"
    assert rl.bound(*models["slow_accum"])["bound_by"] == "bytes"


# -- the benches --------------------------------------------------------------

SMALL = ["--nstand", "16", "--nchan", "32", "--seconds", "0.01"]


@pytest.fixture(scope="module")
def jax_stub_keys():
    """Keys of the JAX script's stub-device line at the same size."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jbench_pipeline.main(SMALL + ["--stub-device", "1.0"]) == 0
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    return set(row), set(row["compute_thread"])


@pytest.mark.parametrize("mode", ["skip_write", "udp", "udp_fx"])
def test_bench_pipeline_stub_matches_jax_keys(mode, capsys, jax_stub_keys):
    keys, thread_keys = jax_stub_keys
    argv = ["--stub-device", "1.0", "--port", str(free_port())]
    if mode == "skip_write":
        argv += SMALL + ["--skip-write"]
    elif mode == "udp":
        # 64 channels: one snap2 packet carries 64
        argv += ["--nstand", "16", "--nchan", "64", "--seconds", "0.01",
                 "--udp"]
    else:
        argv += SMALL + ["--udp", "--fx"]
    assert bench_pipeline.main(argv) == 0
    out = last_json(capsys)
    extra = {"device", "power_limit"} | ({"capture"} if "udp" in mode
                                         else set())
    assert set(out) == keys | extra
    assert set(out["compute_thread"]) == thread_keys
    assert out["metric"] == ("pipeline_fx_host_rate_stub_device"
                             if mode == "udp_fx"
                             else "pipeline_host_rate_stub_device")
    assert out["partial"] is False and out["gulps"] >= 20
    assert out["value"] > 0 and out["stub_device_ms_per_window"] == 1.0
    if "udp" in mode:
        assert set(out["capture"]) == {"npkt", "nmissing", "loss_fraction"}
        assert out["capture"]["nmissing"] == 0


def test_bench_scaling_on_cpu(capsys):
    """Three meshes of up to four CPU shards at the small default config;
    the JAX script's keys and its traffic model's bytes."""
    assert bench_scaling.main(["--cpu", "4", "--niter", "1"]) == 0
    out = last_json(capsys)
    assert {"metric", "platform", "shape", "devices", "per_chip_efficiency",
            "constant_compute_efficiency", "cards"} <= set(out)
    assert out["metric"] == "fx_scaling_strong" and out["cards"] == 0
    assert sorted(out["devices"]) == ["1x1", "2x1", "2x2"]
    assert out["constant_compute_efficiency"]["1x1"] == 1.0
    jcfg = jconfig.XEngineConfig(
        nstand=64, nchan=128, ntime_gulp=48, acc_len=96, acc_len_slow=192,
        nbeam=8, ntime_sum=12, nchan_sum=4, npipeline=2, pfb_ntap=4)
    for key, row in out["devices"].items():
        n_time, n_chan = map(int, key.split("x"))
        vols = jmesh.collective_volumes(jcfg, n_time, n_chan,
                                        gulp_spectra=48)
        assert row["collective_bytes_per_device_per_window"] == {
            v["collective"]: (v["per_device_bytes_per_fire"]
                              * v["fires_per_window"])
            for v in vols["collectives"]}
        assert row["sec_per_window"] > 0 and row["n"] == n_time * n_chan


def test_bench_ingest_engines_over_loopback():
    """Two engines, three gulps each, paced: every gulp reassembled with no
    packet missing."""
    cfg = CFG.replace(nchan=64)
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, [cfg.ntime_gulp, cfg.nchan, cfg.ninput]) \
        .astype(np.uint8)
    r = bench_ingest.run_engines(cfg, [free_port(), free_port()], data,
                                 ngulp=3, delay_ns=20_000)
    assert r["per_engine_gulps"] == [3, 3]
    assert r["nmissing"] == 0 and r["ngot"] == 6
    assert r["npkt"] == 2 * 3 * cfg.ntime_gulp * (cfg.nchan // 64)
    assert r["tx_gbps"] > 0


@pytest.mark.parametrize("module,argv", [
    (bench_step, []), (bench_stages, []),
    (bench_pipeline, ["--seconds", "0"]), (bench_scaling, []),
    (bench_ingest, ["--h2d"])],
    ids=["step", "stages", "pipeline", "scaling", "ingest_h2d"])
def test_device_benches_refuse_a_host_without_a_card(module, argv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert module.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
