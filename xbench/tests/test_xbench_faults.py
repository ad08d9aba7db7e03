"""The comparison fails where it must, at a small shape on the CPU: the
control of each cell, and the faults a cell can have planted in the
program underneath a whole run (a step that leaves its state unchanged,
half of each window left out, an answer altered where it is produced, a
packet lost)."""

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu_torch.io import packets as pk
from caltech_bifrost_dsp_tpu_torch.models import xengine
from xbench import spec
from xbench.cell import run_cell
from xbench.tests.small import SMALL


def run(workload, control=False, cell=None):
    return run_cell(cell or spec.cell(workload), 2 ** 31 + 3, 1.0, False,
                    device="cpu", control=control, override=SMALL,
                    log=lambda s: None)


def failed(out) -> set:
    return {k for k, v in out["checks"].items() if v["value"] > v["limit"]}


def test_the_sound_program_passes():
    for w in ("xb-products", "fx-ingest"):
        out = run(w)
        assert out["correct"] and not failed(out)


def test_xb_control_fails_on_the_beams():
    out = run("xb-products", control=True)
    assert not out["correct"]
    assert failed(out) == {"power_err", "vlbi_err"}


def test_fx_control_fails_on_the_visibilities():
    out = run("fx-ingest", control=True)
    assert not out["correct"] and failed(out) == {"vis_rel_err"}


@pytest.mark.parametrize("workload", ["xb-products", "fx-ingest"])
def test_a_step_that_leaves_its_state_unchanged(monkeypatch, workload):
    real = xengine.xengine_step

    def frozen(state, packed, *a, **kw):
        copy = xengine.XEngineState(*(type(v)(*(p.clone() for p in v))
                                      for v in state))
        _, out = real(copy, packed, *a, **kw)
        return state, out

    monkeypatch.setattr(xengine, "xengine_step", frozen)
    out = run(workload)
    assert not out["correct"]
    assert failed(out) & {"vis_mismatch", "vis_rel_err", "subsel_mismatch"}


@pytest.mark.parametrize("workload", ["xb-products", "fx-ingest"])
def test_half_of_each_window_left_out(monkeypatch, workload):
    real = xengine.xengine_step

    def half(state, packed, *a, **kw):
        return real(state, packed[: packed.shape[0] // 2].contiguous(),
                    *a, **kw)

    monkeypatch.setattr(xengine, "xengine_step", half)
    out = run(workload)
    assert not out["correct"]
    assert failed(out) & {"vis_mismatch", "vis_rel_err", "subsel_mismatch"}


def test_an_altered_voltage_is_caught(monkeypatch):
    real = pk.encode_ibeam

    def altered(hdr, data):
        if hdr.seq % 7 == 3:
            data = data * np.float32(1.001)
        return real(hdr, data)

    monkeypatch.setattr(pk, "encode_ibeam", altered)
    out = run("xb-products")
    assert failed(out) == {"vlbi_err"}


def test_an_altered_visibility_is_caught(monkeypatch):
    real = pk.encode_corr_part

    def altered(hdr, bl, data):
        data = data.copy()
        data[0, 0, 1] += 1
        return real(hdr, bl, data)

    monkeypatch.setattr(pk, "encode_corr_part", altered)
    out = run("xb-products")
    assert failed(out) == {"subsel_mismatch"}


def test_a_lost_packet_is_caught(monkeypatch):
    from caltech_bifrost_dsp_tpu_torch.io import sink

    real = sink.PBeamOutput.send_powers

    def lossy(self, power, seq0, navg):
        kept = dict(self.senders)
        self.senders = {b: s for b, s in kept.items() if b != 1}
        try:
            return real(self, power, seq0, navg)
        finally:
            self.senders = kept

    monkeypatch.setattr(sink.PBeamOutput, "send_powers", lossy)
    out = run("xb-products")
    assert failed(out) == {"packets_bad"}


def test_a_window_that_sent_nothing_is_caught(monkeypatch):
    from caltech_bifrost_dsp_tpu_torch.io import sink

    real = sink.IBeamOutput.send_voltages

    def silent(self, vlbi, seq0):
        if seq0 // SMALL["acc_len"] != 1:
            return real(self, vlbi, seq0)

    monkeypatch.setattr(sink.IBeamOutput, "send_voltages", silent)
    out = run("xb-products")
    assert failed(out) == {"packets_bad"}
    assert out["checks"]["packets_bad"]["value"] == SMALL["acc_len"]


def test_a_ring_of_another_size_is_refused():
    c = spec.cell("fx-ingest")
    c["traffic"] = dict(c["traffic"], pool_gulps=14)
    with pytest.raises(RuntimeError, match="staging ring holds 15"):
        run("fx-ingest", cell=c)


def test_packets_are_compared_whatever_the_input():
    """The channelizer configuration under the products traffic: its
    packets are judged against beams and visibilities of the
    reference's own 4-bit codes.  A code that rounds the other way at a
    threshold moves a beam by a code's weight, so such a cell would need
    numbers of its own; here only that every packet is judged."""
    c = spec.cell("xb-products")
    fx = spec.cell("fx-ingest")
    c["config"] = fx["config"]
    c["workload"] = dict(c["workload"], limits={
        **c["workload"]["limits"], **fx["workload"]["limits"]})
    out = run(None, cell=c)
    ch = out["checks"]
    assert {"vis_rel_err", "packets_bad", "subsel_mismatch", "power_err",
            "vlbi_err"} <= set(ch)
    assert ch["packets_bad"]["value"] == 0
    assert ch["vis_rel_err"]["value"] < 1e-3
    assert 0 < ch["power_err"]["value"] < 1e-2
    assert 0 < ch["vlbi_err"]["value"] < 5e-2
