"""The port's offline CLIs against the JAX package's on one dump file.

The port's ``TriggeredDump`` writes the file (nstand 8, nchan 4, 256
spectra, ``tests/test_offline_cli.py``'s shapes); each package's
``upchan_bf`` (accumulated powers, ``--voltages``, ``--full-obs``) and
``upchan_imag`` replays it into HDF5, the port with ``--device cpu``.
Every group, dataset and attr agrees in name, shape and dtype; values are
equal where they come from the header (frequencies, times, attrs), beams
within rtol 1e-4, atol 1e-4 x max, visibilities exact at nup 2 and within
1e-5 x max at nup 8."""

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.scripts import upchan_bf as jupchan_bf
from caltech_bifrost_dsp_tpu.scripts import upchan_imag as jupchan_imag
from caltech_bifrost_dsp_tpu_torch import config as cfgmod
from caltech_bifrost_dsp_tpu_torch.io import sink, source
from caltech_bifrost_dsp_tpu_torch.runtime.ring import HistoryRing
from caltech_bifrost_dsp_tpu_torch.scripts import upchan_bf, upchan_imag

h5py = pytest.importorskip("h5py")
torch.set_num_threads(1)

CFG = cfgmod.XEngineConfig(nstand=8, nchan=4, ntime_gulp=64, acc_len=128,
                           acc_len_slow=256, nbeam=4, ntime_sum=16,
                           nchan_sum=4, npipeline=2)


@pytest.fixture
def dumpfile(tmp_path):
    rng = np.random.RandomState(0xD0)
    frame_nbyte = CFG.nchan * CFG.ninput
    ring = HistoryRing(nbyte=256 * frame_nbyte, frame_nbyte=frame_nbyte)
    ring.set_header(source.sequence_header(CFG, seq0=0,
                                           sync_time=1_700_000_000),
                    frame0_seq=0)
    for _ in range(256):
        ring.push(rng.randint(0, 256, frame_nbyte).astype(np.uint8))
    files = sink.TriggeredDump(ring, dump_path=str(tmp_path)).trigger(
        ntime_per_file=256, nfile=1)
    return files[0]


def h5_tree(path) -> dict:
    """name -> (kind, attrs, shape, dtype, values) of every group and
    dataset under the root, the root's attrs under ""."""
    out = {}
    with h5py.File(path, "r") as fh:
        out[""] = ("group", dict(fh.attrs), None, None, None)

        def visit(name, obj):
            attrs = dict(obj.attrs)
            if isinstance(obj, h5py.Dataset):
                out[name] = ("dataset", attrs, obj.shape, obj.dtype, obj[()])
            else:
                out[name] = ("group", attrs, None, None, None)

        fh.visititems(visit)
    return out


def assert_same_files(got_path, want_path, rtol, data_names):
    """Same tree; header-derived values equal, ``data_names`` within
    ``rtol`` of max (exact where ``rtol`` is 0)."""
    got, want = h5_tree(got_path), h5_tree(want_path)
    assert sorted(got) == sorted(want)
    for name, (kind, attrs, shape, dtype, values) in want.items():
        gkind, gattrs, gshape, gdtype, gvalues = got[name]
        assert (gkind, gshape, gdtype) == (kind, shape, dtype), name
        assert sorted(gattrs) == sorted(attrs), name
        for k, v in attrs.items():
            np.testing.assert_array_equal(gattrs[k], v, err_msg=name)
        if kind != "dataset":
            continue
        if name in data_names and rtol:
            np.testing.assert_allclose(
                gvalues, values, rtol=rtol,
                atol=rtol * np.abs(values).max(), err_msg=name)
        else:
            np.testing.assert_array_equal(gvalues, values, err_msg=name)
    return got


BF_ARGS = ["--ra-array", "10.0,20.0", "--dec-array", "30.0,40.0",
           "--nupchan", "8", "--gulp", "64"]


@pytest.mark.parametrize("mode, data_names", [
    ([], {"power"}),
    (["--voltages"], {"beam0", "beam1"}),
])
def test_upchan_bf_cli_matches_jax(tmp_path, dumpfile, mode, data_names):
    want, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jupchan_bf.main(["--datain", dumpfile, "--output", want]
                           + BF_ARGS + mode) == 0
    assert upchan_bf.main(["--datain", dumpfile, "--output", got,
                           "--device", "cpu"] + BF_ARGS + mode) == 0
    tree = assert_same_files(got, want, 1e-4, data_names)
    nfine = CFG.nchan * 8
    if mode:
        assert tree["beam1"][2] == (256 // 8, nfine)
    else:
        assert tree["power"][2] == (256 // 64, 2, nfine)
        # rows one gulp of sky apart (gulp / chan_bw), to the float64
        # resolution of a unix time
        np.testing.assert_allclose(np.diff(tree["time"][4]),
                                   64 / CFG.chan_bw_hz, atol=1e-6)


def test_upchan_bf_cli_full_obs_matches_jax(tmp_path, dumpfile):
    args = ["--ra-array", "10.0", "--dec-array", "30.0", "--nupchan", "8",
            "--gulp", "64", "--full-obs", "--obs-nsamples", "16"]
    assert jupchan_bf.main(["--datain", dumpfile, "--output",
                            str(tmp_path / "jax")] + args) == 0
    assert upchan_bf.main(["--datain", dumpfile, "--output",
                           str(tmp_path / "port.h5"), "--device", "cpu"]
                          + args) == 0
    tree = assert_same_files(tmp_path / "port_10.00_30.00.hdf5",
                             tmp_path / "jax_10.00_30.00.hdf5", 1e-4,
                             {"Observation1/Tuning1/I"})
    assert tree["Observation1/Tuning1/I"][2] == (16, CFG.nchan * 8)


def test_upchan_bf_cli_full_obs_refuses_two_beams(tmp_path, dumpfile):
    args = ["--datain", dumpfile, "--output", str(tmp_path / "o"),
            "--ra-array", "10,20", "--dec-array", "30,40", "--nupchan", "8",
            "--gulp", "64", "--full-obs"]
    with pytest.raises(SystemExit) as want:
        jupchan_bf.main(args)
    with pytest.raises(SystemExit) as got:
        upchan_bf.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "single-beam" in str(got.value)
    assert not list(tmp_path.glob("o*"))


@pytest.mark.parametrize("nup, lo, hi, nframe", [
    ("8", "0", "16", "16"),     # two integrations of 16 frames
    ("8", "4", "28", "24"),     # 24 frames, then a partial one of 8
    ("2", "0", "8", "48"),      # 64 frames a gulp: 64, 64 (exact)
])
def test_upchan_imag_cli_matches_jax(tmp_path, dumpfile, nup, lo, hi, nframe):
    args = ["--datain", dumpfile, "--nupchan", nup, "--gulp", "64",
            "--start-freq", lo, "--end-freq", hi,
            "--nframe-per-integration", nframe]
    want, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    assert jupchan_imag.main(args + ["--output", want]) == 0
    assert upchan_imag.main(args + ["--output", got, "--device", "cpu"]) == 0
    tree = assert_same_files(got, want, 1e-5 if nup == "8" else 0, {"vis"})
    vis = tree["vis"][4]
    assert vis.shape[1:] == (int(hi) - int(lo), CFG.ninput, CFG.ninput)
    np.testing.assert_array_equal(vis, np.conj(np.swapaxes(vis, 2, 3)))


@pytest.mark.parametrize("cli", [upchan_bf, upchan_imag])
def test_offline_clis_refuse_cuda_without_a_card(tmp_path, dumpfile, cli,
                                                 capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = str(tmp_path / "x.h5")
    assert cli.main(["--datain", dumpfile, "--output", out]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x.h5").exists()
