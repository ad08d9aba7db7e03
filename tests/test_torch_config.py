"""The port's own copies of ``config.py``, ``runtime/arming.py`` and
``runtime/ring.py`` against the JAX package's: the same fields, defaults,
derived quantities, named configurations and validation errors, and the
same behaviour on one scripted sequence each."""

import dataclasses

import numpy as np
import pytest

from caltech_bifrost_dsp_tpu import config as C
from caltech_bifrost_dsp_tpu.runtime import arming as jarming
from caltech_bifrost_dsp_tpu.runtime import ring as jring
from caltech_bifrost_dsp_tpu_torch import config as TC
from caltech_bifrost_dsp_tpu_torch.runtime import arming, ring

NAMED = ["LWA352", "LWA352_TPU", "TINY", "CPU_REF", "SINGLE_CHIP_SMALL"]
DERIVED = ["ninput", "system_nchan", "spectra_rate_hz", "matlen", "nvis_out",
           "nbaseline", "gulp_nbyte", "adc_np_dtype", "input_gbps", "chan0",
           "sfreq_hz"]


def test_same_fields_and_defaults():
    jf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(C.XEngineConfig)]
    pf = [(f.name, f.type, f.default) for f in
          dataclasses.fields(TC.XEngineConfig)]
    assert pf == jf
    assert dataclasses.asdict(TC.XEngineConfig()) == \
        dataclasses.asdict(C.XEngineConfig())
    for name in ("FS_HZ", "FENGINE_NCHAN", "CHAN_BW_HZ", "SPECTRA_RATE_HZ",
                 "TPU_ENGINES"):
        assert getattr(TC, name) == getattr(C, name)
    with pytest.raises(dataclasses.FrozenInstanceError):
        TC.LWA352.nchan = 1


@pytest.mark.parametrize("name", NAMED)
def test_named_configurations_and_derived_quantities(name):
    jcfg, cfg = getattr(C, name), getattr(TC, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in DERIVED:
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    again = TC.XEngineConfig(**dataclasses.asdict(jcfg))
    assert again == cfg
    assert dataclasses.asdict(cfg.replace(nchan=184, pipeline_id=3)) == \
        dataclasses.asdict(jcfg.replace(nchan=184, pipeline_id=3))


BAD = [dict(acc_len=2401), dict(acc_len_slow=2400 * 3 + 1),
       dict(ntime_gulp=50, acc_len=100, acc_len_slow=100), dict(nchan=190),
       dict(nstand=6), dict(nbeam=3), dict(corr_engine="cuda"),
       dict(bf_engine="fast"), dict(subsel_engine="x"),
       dict(pfb_fft_impl="dft"), dict(pfb_precision="fp8"),
       dict(pfb_engine="triton"), dict(pfb_engine="pallas"),
       dict(adc_dtype="int4")]


@pytest.mark.parametrize("kw", BAD, ids=lambda kw: "-".join(kw))
def test_same_validation_errors(kw):
    with pytest.raises(ValueError) as jerr:
        C.XEngineConfig(**kw)
    with pytest.raises(ValueError) as perr:
        TC.XEngineConfig(**kw)
    assert str(perr.value) == str(jerr.value)


def test_production_engines_are_the_same_and_ask_no_backend():
    """The copy has no ``default_engines``: the JAX helper asks the
    backend, the port's CLI applies ``TPU_ENGINES`` on every device."""
    assert TC.TPU_ENGINES == C.TPU_ENGINES
    assert TC.LWA352_TPU.corr_engine == "pallas_blk"
    assert not hasattr(TC, "default_engines")


def _arming_script(mod):
    """A fast controller through arming, a command, a stop, a restart and
    a sequence break; every decision and the state after it."""
    ctrl = mod.IntegrationController(48, 240, start_time=96,
                                     recover_margin=10)
    log = []

    def feed(t0, n):
        for k in range(n):
            d = ctrl.on_gulp(t0 + 48 * k)
            log.append((t0 + 48 * k, d.action.name, d.is_first, d.seq0,
                        d.acc_len, ctrl.state, ctrl.started))

    ctrl.on_sequence_start(0)
    feed(0, 9)
    ctrl.command(start_time=-1, acc_len=480)
    feed(9 * 48, 14)
    ctrl.command(start_time=-1, acc_len=0)       # stop
    feed(23 * 48, 4)
    ctrl.command(start_time=48 * 30, acc_len=96)
    feed(27 * 48, 8)
    ctrl.on_sequence_start(48 * 50)              # break: re-arm
    log.append(("rearm", ctrl.start_time, ctrl.acc_len, ctrl.state))
    feed(48 * 50, 30)
    slow = mod.IntegrationController(240, 480, start_time=0,
                                     recover_margin=2,
                                     next_boundary_start=False)
    slow.on_sequence_start(0)
    for t in range(0, 240 * 7, 240):
        d = slow.on_gulp(t)
        log.append((t, d.action.name, d.is_first, d.seq0, d.acc_len))
    return log


def test_arming_copies_behave_alike():
    assert _arming_script(arming) == _arming_script(jarming)
    assert [a.name for a in arming.Action] == [a.name for a in jarming.Action]


def _ring_script(mod):
    """Two sequences through a backed ring: reservations filled in place
    and committed, a copied span, a wrap of the ring, contiguous views,
    releases, shutdown."""
    r = mod.Ring("staging", nbyte_budget=6 * 64, backing=True)
    log = [("budget", r.nbyte_budget)]
    seq = r.begin_sequence(time_tag=1, header={"seq0": 0})
    for k in range(3):
        dest = r.reserve_span(64, timeout=1.0)
        dest[:] = k + 1
        r.commit_span(seq, dest)
    r.write_span(seq, np.full(64, 9, np.uint8))
    r.end_sequence(seq)
    seq2 = r.begin_sequence(time_tag=2, header={"seq0": 192})
    reader = r.read()
    s = next(reader)
    log.append(("hdr", s.header, s.time_tag))
    spans = []
    it = r.read_spans(s)
    for _ in range(4):
        spans.append(next(it))
    log.append(("data", [int(x.reshape(-1)[0]) for x in spans],
                [x.nbytes for x in spans]))
    view = r.contiguous_view(spans[:3])
    log.append(("view", None if view is None else
                (view.nbytes, int(view.sum()))))
    log.append(("end", next(it, None) is None))
    for x in spans:
        r.release_span(x)
    # the ring wraps: more reservations than the first lap held
    for k in range(5):
        dest = r.reserve_span(64, timeout=1.0)
        log.append(("reserve", dest is not None))
        dest[:] = 20 + k
        r.commit_span(seq2, dest)
        got = next(r.read_spans(seq2)) if k == 0 else None
        if got is not None:
            log.append(("first", int(got[0])))
    r.end_sequence(seq2)
    r.shutdown()
    s2 = next(reader)
    vals = [int(x.reshape(-1)[0]) for x in r.read_spans(s2)]
    log.append(("seq2", s2.header, vals))
    log.append(("done", next(reader, None) is None,
                r.reserve_span(64, timeout=0.01) is None))
    return log


def test_ring_copies_behave_alike():
    assert _ring_script(ring) == _ring_script(jring)
