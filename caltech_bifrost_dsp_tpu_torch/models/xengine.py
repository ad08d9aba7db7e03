"""The fused X-engine step and its FX variant (port of
``caltech_bifrost_dsp_tpu/models/xengine.py``).

    raw ADC ── pfb_quantize_packed ── packed bytes ─┐   (fx_step only)

    packed 4+4-bit gulp ──┬─ corr_acc ── fast acc ──┬─ subsel (+chan sum)
                          │  (or corr_triu + adds)  └─ slow acc
                          └─ beamform_products ──┬─ dual-pol power
                                                 └─ VLBI voltages

Boundary flags are Python bools, so there is one path: the JAX step's
static-flag branch (xengine.py:191-210), kernels on CUDA tensors and their
plain versions on CPU tensors.  The accumulators live in an
:class:`XEngineState` at the true input width, upper tiles valid, and are
updated IN PLACE by :func:`xengine_step`; the returned state holds the
same tensors.

Engines (``cfg.corr_engine``, ``cfg.subsel_engine``, ``cfg.bf_engine``)
select kernels as the JAX step does: ``"pallas_blk"`` and ``"xla"`` run
the correlator with the accumulator algebra fused in (``corr_acc.cu``);
``"pallas_triu"`` runs the gulp correlator (``corr_triu.cu``) and then
the algebra of xengine.py:231-242 as in-place adds and copies on the
state planes, elementwise work the JAX step leaves to XLA.  Every subsel
engine name runs the one gather and both beamformer names the one fused
beamformer kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import XEngineConfig

from ..ops import corr_subsel as cs
from ..ops import pfb as pfb_ops
from ..ops.beamform import BeamGains, beamform_products
from ..ops.corr_acc import corr_acc
from ..ops.corr_triu import corr_triu
from ..ops.correlate import Vis, mirror_vis, zero_vis


class XEngineState(NamedTuple):
    vis_fast: Vis   # int32 [nchan, ninput, ninput], entries j >= i valid
    vis_slow: Vis   # int32 [nchan, ninput, ninput], entries j >= i valid


class XEngineOutputs(NamedTuple):
    subsel: Vis | None             # int32 [nchan//nchan_sum, nvis_out]
    bf_power: torch.Tensor | None  # f32 [nbeam//2, ntime//ntime_sum,
                                   #      nchan, 4]
    vlbi: torch.Tensor | None      # f32 [ntime, nchan, 2, 2]


def init_state(cfg: XEngineConfig, device=None) -> XEngineState:
    return XEngineState(zero_vis(cfg.nchan, cfg.ninput, device),
                        zero_vis(cfg.nchan, cfg.ninput, device))


def _accumulate(acc: Vis, new: Vis, overwrite: bool) -> None:
    """acc = new if overwrite else acc + new, in place, plane by plane."""
    for a, b in zip(acc, new):
        if overwrite:
            a.copy_(b)
        else:
            a.add_(b)


def xengine_step(state: XEngineState,
                 packed: torch.Tensor,
                 gains: BeamGains,
                 subsel_pairs: torch.Tensor,
                 fast_first: bool,
                 fast_last: bool,
                 slow_first: bool,
                 cfg: XEngineConfig,
                 want_power: bool = True,
                 want_vlbi: bool = True,
                 want_subsel: bool = True,
                 layout: str = "tci"
                 ) -> tuple[XEngineState, XEngineOutputs]:
    """Process one gulp or whole accumulation.

    Args:
      state: accumulators, updated in place.
      packed: uint8 [ntime, nchan, ninput] (``layout="tci"``, the capture
        order) or [nchan, ntime, ninput|padded] (``layout="cti"``; pad
        lanes are don't-care).
      gains: f32 planes [nchan, nbeam, ninput].
      subsel_pairs: int32 [nvis_out, 2] baseline-selection input pairs;
        out-of-range entries clamp to ``cfg.ninput - 1``.
      fast_first: this call begins a fast accumulation (overwrite).
      fast_last: this call completes a fast accumulation; subsel is
        produced and the slow accumulator ingests the fast matrix.
      slow_first: the completed fast dump begins a new slow accumulation.
      want_power / want_vlbi / want_subsel: compute that product at all.

    Returns:
      (state, outputs); ``outputs.subsel`` is None unless ``fast_last``.
    """
    fast, slow = state
    if cfg.corr_engine == "pallas_triu":
        _accumulate(fast, corr_triu(packed, layout, fast.ninput),
                    fast_first)
        if fast_last:
            _accumulate(slow, fast, slow_first)
    else:
        corr_acc(packed, fast, slow, fast_first, fast_last, slow_first,
                 layout=layout)
    subsel = None
    if want_subsel and fast_last:
        subsel = cs.corr_subsel_engine(fast, subsel_pairs, cfg.nchan_sum,
                                       cfg.subsel_engine)
    power, vlbi = beamform_products(packed, gains, cfg.ntime_sum,
                                    want_power, want_vlbi, layout=layout)
    return state, XEngineOutputs(subsel, power, vlbi)


def fx_step(state: XEngineState,
            adc: torch.Tensor,
            window: torch.Tensor,
            quant_scale,
            gains: BeamGains,
            subsel_pairs: torch.Tensor,
            fast_first: bool,
            fast_last: bool,
            slow_first: bool,
            cfg: XEngineConfig,
            want_power: bool = True,
            want_vlbi: bool = True,
            want_subsel: bool = True,
            layout: str = "tci"
            ) -> tuple[XEngineState, XEngineOutputs]:
    """FX variant: raw ADC -> PFB -> 4-bit requant -> X/B step.

    Args:
      adc: f32 or int8 [(ntime + pfb_ntap - 1) * 2 * nchan, ninput] real
        ADC samples, the first ntap-1 frames being the FIR history carried
        from the previous call.  int8 gives the same products as the same
        values in f32.
      window: f32 [pfb_ntap, 2*nchan] prototype filter.
      quant_scale: scalar or per-channel [nchan] requant gain.

    The input-major packed bytes are corner-turned to ``layout`` ("tci"
    [ntime, nchan, ninput] or "cti" [nchan, ntime, ninput]) with one
    permute, as the JAX step does (xengine.py:298-299); every
    ``cfg.pfb_fft_impl`` takes the one channelizer.
    """
    if layout not in ("tci", "cti"):
        raise ValueError(f"unknown layout {layout!r}")
    pk = pfb_ops.channelize_pack_imajor(adc, window, cfg, quant_scale)
    order = (2, 1, 0) if layout == "cti" else (1, 2, 0)
    packed = pk.permute(*order).contiguous()
    return xengine_step(state, packed, gains, subsel_pairs, fast_first,
                        fast_last, slow_first, cfg, want_power, want_vlbi,
                        want_subsel, layout)


def dense_vis(vis: Vis, cfg: XEngineConfig) -> Vis:
    """Accumulator -> full Hermitian matrix [nchan, ninput, ninput]
    (mirrors the upper-valid half).  Called per dump, off the hot path."""
    if vis.ninput != cfg.ninput:
        raise ValueError("state width differs from cfg.ninput")
    return mirror_vis(vis)


def default_inputs(cfg: XEngineConfig, seed: int = 0, device=None):
    """State + example inputs: random packed tci gulp, unit gains and the
    production-shaped baseline selection (autos cycling for configs too
    small to hold it) -- the same draws as the JAX ``default_inputs``."""
    rng = np.random.RandomState(seed)
    packed = torch.from_numpy(rng.randint(
        0, 255, [cfg.ntime_gulp, cfg.nchan, cfg.ninput]).astype(np.uint8))
    gains = BeamGains(
        torch.ones((cfg.nchan, cfg.nbeam, cfg.ninput), dtype=torch.float32,
                   device=device),
        torch.zeros((cfg.nchan, cfg.nbeam, cfg.ninput), dtype=torch.float32,
                    device=device))
    pairs = torch.from_numpy(cs.baselines_to_inputs(
        cs.production_baselines(cfg.nvis_out, cfg.nstand, cfg.npol),
        cfg.npol).astype(np.int32))
    return (init_state(cfg, device), packed.to(device), gains,
            pairs.to(device))


def state_from_numpy(state, cfg: XEngineConfig, device=None) -> XEngineState:
    """Carry a JAX ``XEngineState`` into the port.

    ``state`` is ``((fast_real, fast_imag), (slow_real, slow_imag))`` as
    numpy arrays (``jax.device_get`` of a JAX state has that structure).
    Planes wider than ``cfg.ninput`` -- the JAX block engine's 256-padded
    width -- are sliced to ``ninput``.
    """
    n = cfg.ninput

    def plane(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.int32)[:, :n, :n])
        return torch.from_numpy(a).to(device)

    (fr, fi), (sr, si) = state
    return XEngineState(Vis(plane(fr), plane(fi)), Vis(plane(sr), plane(si)))


def gains_from_numpy(real, imag, device=None) -> BeamGains:
    """Raw gain planes [nchan, nbeam, ninput] (numpy) -> BeamGains."""
    def plane(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype=np.float32))).to(device)

    return BeamGains(plane(real), plane(imag))
