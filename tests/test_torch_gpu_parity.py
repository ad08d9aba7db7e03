"""The port's golden-parity gate (``scripts/gpu_parity.py``) at a tiny
geometry on the CPU, beside the JAX gate (``scripts/tpu_parity.py``).

On the CPU every wrapper takes its plain version, so these tests check the
gate's logic: the host truths and their conventions, the artifact's keys
and verdicts against the JAX gate's on the same arguments, that a single
perturbed element fails the gate, and the exits without a card.  The gate
itself runs on the card (``python -m
caltech_bifrost_dsp_tpu_torch.scripts.gpu_parity``)."""

import json

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu.scripts import tpu_parity
from caltech_bifrost_dsp_tpu_torch.scripts import gpu_parity

TINY = ["--tiny", "--nchan", "16", "--ntime", "288", "--nstand", "8"]
#: keys of a geometry record that the JAX gate's lacks: the host truth's
#: anchor to the golden correlation (an assert in the JAX gate) and the
#: host truth's seconds
PORT_ONLY_GEOMETRY_KEYS = {"anchor", "host_seconds"}


def _run_port(out, *extra) -> tuple[int, dict]:
    rc = gpu_parity.main(TINY + ["--device", "cpu", "--out", str(out),
                                 *extra])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _run_port(tmp_path_factory.mktemp("port") / "parity.json")


@pytest.fixture(scope="module")
def jax(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "parity.json"
    rc = tpu_parity.main(TINY + ["--out", str(out)])
    return rc, json.loads(out.read_text())


def test_gate_passes_tiny_on_cpu(port):
    rc, art = port
    assert rc == 0
    assert art["pass"] is True
    assert art["backend"] == "cpu" and art["card"] is None
    assert art["engines"] == {"corr_engine": "pallas_blk", "bf_engine":
                              "pallas", "subsel_engine": "bands"}
    assert art["layout"] == "cti"
    geom = art["geometries"]["16c"]
    assert len(geom["windows"]) == 3
    for win in geom["windows"]:
        assert all(win[k] == {"exact": True} for k in gpu_parity.EXACT_KEYS)
        assert win["power"]["allclose_rtol1e-4"]
    assert geom["slow_re"] == geom["slow_im"] == {"exact": True}
    assert geom["anchor"] == {"nchan": 2, "re": {"exact": True},
                              "im": {"exact": True}}
    fx = art["fx"]
    assert fx["pass"] and fx["int8_eq_f32"]
    assert fx["byte_gate"]["bad"] == 0
    assert fx["chunks"] is None and fx["chunks_reason"]


def test_gate_agrees_with_the_jax_gate(port, jax):
    (rc, art), (jrc, jart) = port, jax
    assert rc == jrc == 0
    assert art["pass"] == jart["pass"]
    assert set(art["geometries"]) == set(jart["geometries"])
    for name, jgeom in jart["geometries"].items():
        geom = art["geometries"][name]
        assert set(geom) == set(jgeom) | PORT_ONLY_GEOMETRY_KEYS
        for k in ("nchan", "ntime", "nstand", "acc_len", "slow_re",
                  "slow_im", "pass"):
            assert geom[k] == jgeom[k], k
        assert len(geom["windows"]) == len(jgeom["windows"])
        for win, jwin in zip(geom["windows"], jgeom["windows"]):
            assert set(win) == set(jwin)
            for k in gpu_parity.EXACT_KEYS:
                assert win[k] == jwin[k], (k, win[k], jwin[k])
            assert (win["power"]["allclose_rtol1e-4"]
                    == jwin["power"]["allclose_rtol1e-4"])
    fx, jfx = art["fx"], jart["fx"]
    for k in ("nspec", "nchan", "ninput", "int8_eq_f32", "pass"):
        assert fx[k] == jfx[k], k
    assert (fx["high_vs_host"]["frac_identical"]
            >= jfx["high_vs_host"]["frac_identical"])
    assert (fx["high_vs_host"]["max_lsb_diff"]
            <= jfx["high_vs_host"]["max_lsb_diff"])


def _truth_inputs():
    rng = np.random.RandomState(7)
    block = rng.randint(0, 255, [96, 8, 8, 2], dtype=np.uint8)
    gr = rng.randint(-8, 9, [8, 4, 16]).astype(np.float32)
    gi = rng.randint(-8, 9, [8, 4, 16]).astype(np.float32)
    return block, gr, gi


@pytest.mark.parametrize("name", ["host_beams", "host_power", "host_subsel"])
def test_host_truth_equals_the_jax_copy(name):
    block, gr, gi = _truth_inputs()
    if name == "host_beams":
        args = (block, gr, gi)
    elif name == "host_power":
        args = (*gpu_parity.host_beams(block, gr, gi), 12)
    else:
        rng = np.random.RandomState(8)
        pairs = rng.randint(0, 16, [40, 2]).astype(np.int32)
        args = (*tpu_parity.host_corr_int32(block), pairs, 4)
    got = getattr(gpu_parity, name)(*args)
    want = getattr(tpu_parity, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_perturbed_fast_element_fails_the_gate(tmp_path, monkeypatch):
    """One element of the first window's fast accumulator off by one: the
    gate counts exactly that element and exits 1."""
    step = gpu_parity.xengine_step
    calls = []

    def perturbed(state, *args, **kw):
        state, outs = step(state, *args, **kw)
        if not calls:
            state.vis_fast.real[0, 0, 0] += 1   # the diagonal: one element
        calls.append(1)
        return state, outs

    monkeypatch.setattr(gpu_parity, "xengine_step", perturbed)
    rc, art = _run_port(tmp_path / "parity.json", "--no-fx")
    assert rc == 1
    assert art["pass"] is False
    geom = art["geometries"]["16c"]
    assert geom["pass"] is False
    first, *rest = geom["windows"]
    assert first["fast_re"] == {"exact": False, "mismatches": 1,
                                "max_abs_diff": 1}
    assert all(first[k] == {"exact": True}
               for k in gpu_parity.EXACT_KEYS if k != "fast_re")
    assert all(win[k] == {"exact": True} for win in rest
               for k in gpu_parity.EXACT_KEYS)
    # the slow sum took the fast matrix before the perturbation
    assert geom["slow_re"] == geom["slow_im"] == {"exact": True}


def test_partial_runs_merge(tmp_path):
    out = tmp_path / "parity.json"
    assert _run_port(out, "--no-fx")[0] == 0
    rc, art = _run_port(out, "--only-fx")
    assert rc == 0 and art["pass"]
    assert set(art["geometries"]) == {"16c"} and art["fx"]["pass"]


def test_cpu_without_tiny_exits_2(tmp_path):
    out = tmp_path / "parity.json"
    assert gpu_parity.main(["--device", "cpu", "--out", str(out)]) == 2
    assert not out.exists()


def test_cuda_without_a_card_exits_2(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "parity.json"
    assert gpu_parity.main(TINY + ["--out", str(out)]) == 2
    assert gpu_parity.main(["--out", str(out)]) == 2
    assert not out.exists()
