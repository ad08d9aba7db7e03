"""The driver's slow-dump fetch (``runtime/driver.py::XEnginePipeline.
_fetch``).

On a card every slow dump's two planes come down into one page-locked
pair that the pipeline allocates once and reuses; the sinks see numpy
views of it, valid until their call returns, and ``ProductKeeper`` keeps
copies.  These tests, marked ``cuda``, run three slow dumps of X/B (with
the selftest), FX and X/B on a 2x2 mesh of one card into a keeper and
hold each kept dump to the sum of its period's fast matrices, every kept
array to its own memory, and the ``Corr`` counters to one pinned fetch a
slow dump from a pair of constant size.  On the CPU and under the stub
device nothing is pinned or counted and the dumps stay exact.

On a GPU host: ``python -m pytest --noconftest tests/test_torch_fetch.py``
"""

import itertools

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io.source import ADCSource, SyntheticSource
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.scripts.soak import FX_CFG
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)

NSLOW = 3
COUNTERS = ("slow_fetch_pinned", "slow_pinned_nbyte")


@pytest.fixture(autouse=True)
def _fresh():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


class AtDump:
    """A slow-dump sink beside the keeper: at each call, the counters and
    the address of the real plane handed over."""

    checkfile = None

    def __init__(self, pipe):
        self.pipe = pipe
        self.seen: list = []

    def send_matrix_planes(self, vis_re, vis_im, sync_time, spectra_id,
                           acc_len) -> int:
        stats = self.pipe.corr_cmd.stats
        self.seen.append((tuple(stats[k] for k in COUNTERS),
                          vis_re.__array_interface__["data"][0]))
        return 0


class Run:
    """``NSLOW`` slow dumps of ``kind`` on ``device`` into a keeper, and
    every fast matrix as the compute thread queued it."""

    def __init__(self, kind: str, device: str):
        fx = kind == "fx"
        cfg = FX_CFG if fx else TC.TINY
        src = (ADCSource(cfg, mode="noise", amplitude=20.0) if fx
               else SyntheticSource(cfg, mode="random"))
        mesh = (pm.make_mesh(2, 2, devices=[device] * 4)
                if kind == "xb-mesh" else None)
        self.keeper = sink.ProductKeeper()
        stub = 1.0 if kind == "stub" else None
        pipe = XEnginePipeline(cfg, src, device=device, fx_mode=fx,
                               quant_scale=0.2, selftest=kind == "xb",
                               mesh=mesh, stub_device_ms=stub,
                               corr_outputs=[self.keeper])
        self.at = AtDump(pipe)
        pipe.corr_outputs.append(self.at)
        self.fast: list = []
        emit = pipe._emit

        def keep_fast(out, t, dec, slow_dec):
            n = pipe.ndump_fast
            emit(out, t, dec, slow_dec)
            if pipe.ndump_fast > n and pipe.state is not None:
                self.fast.append(tuple(p.cpu().numpy().astype(np.int64)
                                       for p in pipe._dense("fast")))

        pipe._emit = keep_fast
        self.per_slow = cfg.acc_len_slow // cfg.acc_len
        pipe.run(NSLOW * cfg.acc_len_slow // cfg.ntime_gulp, timeout_s=600)
        self.pipe = pipe
        self.stats = {k: pipe.corr_cmd.stats[k] for k in COUNTERS}
        self.cfg = cfg

    def check_dumps(self) -> None:
        """Each kept dump is the sum of its period's fast matrices (zeros
        under the stub), and no two kept arrays share memory."""
        cfg, kept = self.cfg, self.keeper.slow
        assert self.pipe.ndump_slow == NSLOW
        assert list(kept) == [k * cfg.acc_len_slow for k in range(NSLOW)]
        for k, planes in enumerate(kept.values()):
            if self.fast:
                period = self.fast[k * self.per_slow:(k + 1) * self.per_slow]
                want = [sum(f[i] for f in period) for i in range(2)]
            else:
                want = [np.zeros((cfg.nchan, cfg.ninput, cfg.ninput))] * 2
            for got, w in zip(planes, want):
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, w)
        if self.fast:
            # the dumps differ, so a pair overwritten under the keeper shows
            first = next(iter(kept.values()))[0]
            assert any(not np.array_equal(first, p[0])
                       for p in kept.values())
        arrays = [a for planes in kept.values() for a in planes]
        for a, b in itertools.combinations(arrays, 2):
            assert not np.shares_memory(a, b)


@pytest.mark.parametrize("kind", ["xb", "fx", "stub"])
def test_cpu_fetches_nothing_pinned(kind):
    """No card: no pair, no pinned fetch counted, the dumps exact."""
    r = Run(kind, "cpu")
    assert r.pipe._slow_host is None
    assert r.stats == dict.fromkeys(COUNTERS, 0)
    assert [s for s, _ in r.at.seen] == [(0, 0)] * NSLOW
    r.check_dumps()
    if kind == "xb":
        assert (r.pipe.selftest_count, r.pipe.selftest_failures) == (
            NSLOW * r.per_slow, 0)


def test_keeper_copies_the_planes():
    """``ProductKeeper`` keeps copies: the caller may overwrite what it
    handed over once the call returned."""
    keeper = sink.ProductKeeper()
    re = np.arange(24, dtype=np.int32).reshape(2, 3, 4)
    im = -re
    assert keeper.send_matrix_planes(re, im, 0, 480, 480) == 0
    kr, ki = keeper.slow[480]
    assert not np.shares_memory(kr, re) and not np.shares_memory(ki, im)
    re[...] = 7
    im[...] = 7
    np.testing.assert_array_equal(kr, np.arange(24).reshape(2, 3, 4))
    np.testing.assert_array_equal(ki, -np.arange(24).reshape(2, 3, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["xb", "fx", "xb-mesh"])
def test_slow_dumps_come_down_into_one_pinned_pair(card, kind):
    """Every slow dump is fetched into the pipeline's one page-locked pair,
    counted, and kept exact by the keeper's copies."""
    r = Run(kind, card)
    pair = r.pipe._slow_host
    cfg = r.cfg
    nbyte = 2 * cfg.nchan * cfg.ninput ** 2 * 4
    assert all(h.is_pinned() for h in pair)
    assert r.stats == {"slow_fetch_pinned": NSLOW,
                       "slow_pinned_nbyte": nbyte}
    assert r.pipe.corr_cmd.stats["slow_dumps"] == NSLOW
    # counted before the sinks see a dump, from a pair of one size, and
    # every dump handed over in the same memory
    assert [s for s, _ in r.at.seen] == [(k + 1, nbyte)
                                         for k in range(NSLOW)]
    assert {a for _, a in r.at.seen} == {pair[0].data_ptr()}
    r.check_dumps()
    for planes in r.keeper.slow.values():
        for a in planes:
            assert not any(np.shares_memory(a, h.numpy()) for h in pair)
    if kind == "xb":
        assert (r.pipe.selftest_count, r.pipe.selftest_failures) == (
            NSLOW * r.per_slow, 0)
