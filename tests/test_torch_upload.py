"""The driver's upload (``runtime/driver.py::XEnginePipeline._upload``).

On a card the staging ring is registered page-locked and a window goes up
from the ring itself; these tests, marked ``cuda``, hold such runs to the
same runs with the ring left unregistered (every window through a pinned
buffer), byte for byte: X/B with the selftest, FX, and X/B on a 2x2 mesh
of one card.  A window that is not one view of the ring goes through the
pinned buffer; dropping a pipeline unregisters its ring.  On the CPU the
driver registers nothing, counts no upload and steps as before.

On a GPU host: ``python -m pytest --noconftest tests/test_torch_upload.py``
"""

import gc
import time

import numpy as np
import pytest
import torch

from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.control.command import CommandBlock
from caltech_bifrost_dsp_tpu_torch.io import sink
from caltech_bifrost_dsp_tpu_torch.io.source import ADCSource, SyntheticSource
from caltech_bifrost_dsp_tpu_torch.parallel import mesh as pm
from caltech_bifrost_dsp_tpu_torch.runtime import driver
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline
from caltech_bifrost_dsp_tpu_torch.scripts.soak import FX_CFG
from caltech_bifrost_dsp_tpu_torch.utils import proclog

torch.set_num_threads(1)

XB_CFG = TC.TINY
NWIN = 6
COUNTERS = ("upload_direct", "upload_staged", "staging_registered_nbyte")


@pytest.fixture(autouse=True)
def _fresh():
    CommandBlock.reset_instance_counts()
    proclog.clear_registry()
    yield
    proclog.enable_spans(False)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


class Run:
    """One pipeline over ``NWIN`` windows with every sink, its packets
    kept; ``prepare(pipe)`` runs before the pipeline does."""

    def __init__(self, kind: str, device: str, prepare=None,
                 batch: bool = True, spans: bool = False):
        fx = kind == "fx"
        cfg = FX_CFG if fx else XB_CFG
        self.packets = {"cor": [], "sub": [], "pb": [], "ib": []}
        p = self.packets
        src = (ADCSource(cfg, mode="noise", amplitude=20.0) if fx
               else SyntheticSource(cfg, mode="random"))
        mesh = (pm.make_mesh(2, 2, devices=[device] * 4)
                if kind == "xb-mesh" else None)
        pipe = XEnginePipeline(
            cfg, src, device=device, fx_mode=fx, quant_scale=0.2,
            selftest=not fx, mesh=mesh, batch_accumulations=batch,
            corr_outputs=[sink.CorrFullOutput(cfg, send=p["cor"].append,
                                              use_cor_fmt=True)],
            subsel_outputs=[sink.CorrPartOutput(cfg, send=p["sub"].append)],
            pbeam_outputs=[sink.PBeamOutput(
                cfg, senders={b: p["pb"].append
                              for b in range(cfg.nbeam // 2)})],
            ibeam_outputs=[sink.IBeamOutput(cfg, send=p["ib"].append)])
        if prepare is not None:
            prepare(pipe)
        proclog.enable_spans(spans)
        t0 = time.time_ns()
        pipe.run(NWIN * cfg.acc_len // cfg.ntime_gulp, timeout_s=600)
        proclog.enable_spans(False)
        self.span_names = {r[0] for r in proclog.spans_between(
            t0, time.time_ns())}
        self.stats = {k: pipe.corr_cmd.stats[k] for k in COUNTERS}
        self.nstep = pipe.ndump_fast if batch else NWIN * (
            cfg.acc_len // cfg.ntime_gulp)
        self.ring_nbyte = pipe.staging.nbyte_budget
        self.selftest = (pipe.selftest_count, pipe.selftest_failures)
        self.ndump = (pipe.ndump_fast, pipe.ndump_slow)
        self.nslow = NWIN * cfg.acc_len // cfg.acc_len_slow
        self.state = ([x.cpu().numpy() for v in pipe.state for x in v]
                      if mesh is None else None)

    def same_products(self, other: "Run") -> None:
        assert self.ndump == other.ndump == (NWIN, self.nslow)
        for k, pkts in self.packets.items():
            assert pkts, k
            # PBEAM sends per step call: its order follows the batching
            assert sorted(pkts) == sorted(other.packets[k]), k
        if self.state is not None:
            for a, b in zip(self.state, other.state):
                np.testing.assert_array_equal(a, b)


def unregister(pipe) -> None:
    """Leave the ring unregistered: every window through a pinned buffer."""
    pipe._ring_lock()


@pytest.mark.parametrize("kind", ["xb", "fx", "stub"])
def test_cpu_registers_nothing_and_steps(kind):
    """No card: nothing registered, no upload counted, and the windows
    step as the per-gulp path steps them (X/B: the selftest besides)."""
    if kind == "stub":
        pipe = XEnginePipeline(XB_CFG, SyntheticSource(XB_CFG), device="cpu",
                               stub_device_ms=1.0)
        pipe.run(2 * XB_CFG.acc_len // XB_CFG.ntime_gulp, timeout_s=120)
        assert pipe.ndump_fast == 2 and pipe._ring_lock is None
        assert {k: pipe.corr_cmd.stats[k] for k in COUNTERS} == dict.fromkeys(
            COUNTERS, 0)
        return
    batched = Run(kind, "cpu", spans=True)
    per_gulp = Run(kind, "cpu", batch=False)
    for r in (batched, per_gulp):
        assert r.stats == dict.fromkeys(COUNTERS, 0)
        assert "compute.upload.copy" not in r.span_names
        if kind == "xb":
            assert r.selftest == (NWIN, 0)
    assert "compute.upload" in batched.span_names
    batched.same_products(per_gulp)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["xb", "fx", "xb-mesh"])
def test_direct_upload_equals_staged(card, kind):
    """Each window goes up from the registered ring, never through a pinned
    copy, and the products are those of the staged path, bit for bit."""
    direct = Run(kind, card, spans=True)
    staged = Run(kind, card, prepare=unregister, spans=True)
    assert direct.stats == {"upload_direct": direct.nstep,
                            "upload_staged": 0,
                            "staging_registered_nbyte": direct.ring_nbyte}
    assert staged.stats == {"upload_direct": 0,
                            "upload_staged": staged.nstep,
                            "staging_registered_nbyte": 0}
    assert "compute.upload.copy" not in direct.span_names
    assert "compute.upload.copy" in staged.span_names
    if kind == "xb":
        assert direct.selftest == staged.selftest == (NWIN, 0)
    direct.same_products(staged)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["xb", "fx"])
def test_window_not_one_view_goes_staged(card, kind):
    """Every other window handed over as spans that are not one view of
    the ring takes the pinned copy; the products do not change."""
    def split(pipe):
        view = pipe.staging.contiguous_view
        calls = []

        def every_other(spans):
            calls.append(None)
            return None if len(calls) % 2 else view(spans)
        pipe.staging.contiguous_view = every_other

    mixed = Run(kind, card, prepare=split)
    direct = Run(kind, card)
    assert mixed.stats["upload_staged"] == (mixed.nstep + 1) // 2
    assert mixed.stats["upload_direct"] == mixed.nstep // 2
    mixed.same_products(direct)


@pytest.mark.cuda
def test_dropping_a_pipeline_unregisters_its_ring(card):
    """The ring's registration goes with its pipeline, so the next
    pipeline, whose ring may take the same pages, registers its own."""
    for _ in range(3):
        pipe = XEnginePipeline(FX_CFG, ADCSource(FX_CFG), device=card,
                               fx_mode=True)
        lock = pipe._ring_lock
        assert lock is not None and lock.alive
        assert pipe.corr_cmd.stats["staging_registered_nbyte"] == \
            pipe.staging.nbyte_budget
        pipe.run(FX_CFG.acc_len // FX_CFG.ntime_gulp, timeout_s=300)
        assert pipe.corr_cmd.stats["upload_direct"] == pipe.ndump_fast == 1
        del pipe
        gc.collect()
        assert not lock.alive
    # the runtime took no error from the registrations: a copy still works
    assert torch.ones(4, device=card).sum().item() == 4


@pytest.mark.cuda
def test_a_refused_registration_leaves_no_error(card):
    """Where the runtime refuses the registration (here: the pages are
    registered already) the ring stays pageable, and the refusal does not
    surface at the next kernel launch."""
    rt = torch.cuda.cudart()
    buf = np.zeros(1 << 22, np.uint8)
    ptr = buf.__array_interface__["data"][0]
    assert int(rt.cudaHostRegister(ptr, buf.nbytes, 0)) == 0
    try:
        assert driver._page_lock(buf, torch.device(card)) is None
        assert (torch.ones(1 << 10, device=card) * 2).sum().item() == 2048
    finally:
        assert int(rt.cudaHostUnregister(ptr)) == 0
