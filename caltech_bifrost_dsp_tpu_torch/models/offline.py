"""Offline pipelines: upchannelizing beamformer and imaging correlator
(port of ``caltech_bifrost_dsp_tpu/models/offline.py``, the same names).

Analogs of the reference's high-level-API offline pipelines (reference:
pipeline/scripts/lwa352-upchan-bf.py and lwa352-upchan-imag.py): each is a
host loop over gulps of a replayed trigger-buffer file with the work of a
gulp on the device.  A gulp of packed 4+4-bit bytes [time, chan, stand,
pol] goes to the device as bytes and is unpacked there, reshaped to
(time, NUPCHAN) frames and FFT'd over the fine axis; beam weights are
applied per (chan, fine, stand, pol), or visibilities integrated per fine
channel in place.

No kernel of the port's own stands behind this module: the JAX package
computes these steps outside any Pallas kernel (``jnp.fft`` and two
``jnp.einsum`` products), and so the port uses ``torch.fft`` and
``torch.bmm``, in full float32 whatever the caller's TF32 setting.
:class:`OfflineBeamConfig` and :func:`compute_offline_weights` stay numpy
on the host, so the weights are bit-equal to the JAX package's.  The run
functions return numpy arrays, as the JAX ones do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import pfb as pfb_ops
from ..utils import skycoords
from ..utils.codec import unpack


@dataclass
class OfflineBeamConfig:
    """Pointing + calibration for one offline beamforming run
    (reference: BfOfflineWeightsBlock.__init__, beamform_offline_block.py:50).
    """
    nbeam: int
    ra_deg: list
    dec_deg: list
    enz_positions: np.ndarray          # [nstand, 3] meters
    lat_deg: float = 37.2398          # OVRO-LWA site
    lon_deg: float = -118.2817
    nupchan: int = 32
    ntimestep: int = 1000             # samples between weight updates
    cal_gains: np.ndarray | None = None  # complex [nchan_fine, nstand*npol]
    weighting: np.ndarray = field(default=None)  # [nstand] taper


def compute_offline_weights(cfg: OfflineBeamConfig, freqs_hz: np.ndarray,
                            t_unix: float) -> np.ndarray:
    """Per-beam complex weights [nbeam, nchan_fine, nstand*npol].

    Geometric delays from antenna ENZ positions toward (ra, dec) at
    ``t_unix`` (beamform_offline_block.py:110-142 ``compute_weights``),
    times calibration gains when provided.
    """
    npol = 2
    nstand = len(cfg.enz_positions)
    taper = (np.ones(nstand) if cfg.weighting is None
             else np.clip(cfg.weighting, 0, 1))
    weights = np.empty((cfg.nbeam, len(freqs_hz), nstand * npol),
                       np.complex64)
    for b in range(cfg.nbeam):
        az, alt = skycoords.radec_to_altaz(cfg.ra_deg[b], cfg.dec_deg[b],
                                           t_unix, cfg.lat_deg,
                                           cfg.lon_deg)
        delays_s = skycoords.geometric_delays_s(cfg.enz_positions, az, alt)
        # amplitude taper multiplies the WEIGHT, never the delay: taper
        # inside the exponential leaves |w|==1 (no attenuation) and
        # mis-points the tapered antenna's phase instead
        wdel = np.repeat(delays_s, npol)                  # [nstand*npol]
        amp = np.repeat(taper, npol)
        w = amp[None, :] * np.exp(
            2j * np.pi * freqs_hz[:, None] * wdel[None, :])
        if cfg.cal_gains is not None:
            # cal_gains: complex [nchan_fine, nstand*npol]
            w = w * cfg.cal_gains
        weights[b] = w.astype(np.complex64)
    return weights


def upchannelize_gulp(voltages: torch.Tensor, nupchan: int) -> torch.Tensor:
    """[time, chan, stand, pol] complex voltages ->
    [time//nupchan, chan, nupchan(fine), stand, pol], contiguous
    (the transpose->fft('fine_time') chain, lwa352-upchan-bf.py:94-97)."""
    fine = pfb_ops.upchannelize(voltages, nupchan)  # [T, nup, chan, s, p]
    return fine.permute(0, 2, 1, 3, 4).contiguous()


def apply_weights_and_sum(fine: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """Beamform the upchannelized data.

    Args:
      fine: complex64 [T, chan, fine, stand, pol].
      weights: complex64 [nbeam, chan*fine, stand*pol], applied
        unconjugated.

    Returns:
      complex64 [T, nbeam, chan*fine]: ``einsum("tfi,bfi->tbf")``, weights
      applied then reduced over stand and pol (the blocks.reduce
      'stand'/'pol' chain, lwa352-upchan-bf.py:119-121), as one batched
      product over the fine channels.
    """
    T, nchan, nfine, nstand, npol = fine.shape
    x = fine.reshape(T, nchan * nfine, nstand * npol).transpose(0, 1)
    with pfb_ops.full_fp32_matmul():
        beams = torch.bmm(x, weights.permute(1, 2, 0))   # [F, T, nbeam]
    return beams.permute(1, 2, 0)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda but no CUDA device is available")
    return dev


def _gulp_to_device(packed: np.ndarray, dev: torch.device,
                    stage: torch.Tensor | None) -> torch.Tensor:
    """Packed bytes [time, chan, stand, pol] -> complex64 voltages on
    ``dev``: the bytes cross to the device (through the pinned ``stage``
    on a card) and are unpacked there."""
    if stage is None:
        raw = torch.from_numpy(np.array(packed, np.uint8))
    else:
        stage.numpy()[...] = packed
        raw = stage.to(dev)
    re, im = unpack(raw)
    return torch.complex(re.float(), im.float())


def _stage(shape, dev: torch.device) -> torch.Tensor | None:
    if dev.type != "cuda":
        return None
    return torch.empty(shape, dtype=torch.uint8, pin_memory=True)


def upchan_beamform_run(voltages_packed: np.ndarray, cfg: OfflineBeamConfig,
                        sfreq_hz: float, chan_bw_hz: float,
                        t_unix: float = 0.0, gulp_ntime: int = 480,
                        accumulate: bool = True, device="cuda"):
    """Full offline upchan + beamform pass over a trigger-buffer array.

    Args:
      voltages_packed: uint8 [ntime, nchan, nstand, npol] 4+4-bit.
      accumulate: if True, average beam powers over each gulp
        (AccumHDF5SaveBlock semantics); else return voltages per gulp.
      device: where the gulps are computed ("cuda" unless asked).

    Returns:
      (fine_freqs_hz, list of per-gulp numpy outputs: float32 [nbeam,
      nchan*nupchan] powers, or complex64 [T', nbeam, nchan*nupchan]
      voltages).
    """
    dev = _device(device)
    ntime, nchan, nstand, npol = voltages_packed.shape
    nup = cfg.nupchan
    fine_bw = chan_bw_hz / nup
    # fine-channel center frequencies after fftshift (fine index 0 = most
    # negative offset)
    offsets = (np.arange(nup) - nup // 2) * fine_bw
    freqs = (sfreq_hz + np.arange(nchan) * chan_bw_hz)[:, None] + offsets
    freqs = freqs.reshape(-1)
    weights = torch.from_numpy(
        compute_offline_weights(cfg, freqs, t_unix)).to(dev)
    stage = _stage((gulp_ntime, nchan, nstand, npol), dev)
    outputs = []
    next_update = cfg.ntimestep  # samples between weight updates
    for g0 in range(0, ntime - gulp_ntime + 1, gulp_ntime):
        if g0 >= next_update:
            # track sky rotation across a long replay: recompute the
            # geometric weights every ntimestep samples (the reference
            # BfOfflineWeightsBlock's update cadence); one spectrum =
            # 1/chan_bw seconds of sky time
            weights = torch.from_numpy(compute_offline_weights(
                cfg, freqs, t_unix + g0 / chan_bw_hz)).to(dev)
            next_update = g0 + cfg.ntimestep
        gulp = _gulp_to_device(voltages_packed[g0:g0 + gulp_ntime], dev,
                               stage)
        fine = upchannelize_gulp(gulp, nup)
        beams = apply_weights_and_sum(fine, weights)  # [T', nbeam, F]
        if accumulate:
            outputs.append(beams.abs().square().mean(0).cpu().numpy())
        else:
            outputs.append(beams.cpu().numpy())
    return freqs, outputs


def upchan_select_gulp(voltages: torch.Tensor, nupchan: int, chan_lo: int,
                       chan_hi: int) -> torch.Tensor:
    """Upchannelize, merge (chan, fine) axes and slice a channel range:
    the transpose/merge_axes/FrequencySelectBlock chain
    (lwa352-upchan-imag.py:95-101, imaging_offline_block.py:28-77).

    Returns complex64 [T', chan_hi-chan_lo, stand, pol] (a view).
    """
    fine = upchannelize_gulp(voltages, nupchan)  # [T', c, f, s, p]
    T, nchan, nfine, nstand, npol = fine.shape
    merged = fine.reshape(T, nchan * nfine, nstand, npol)
    return merged[:, chan_lo:chan_hi]


def correlate_offline(voltages: torch.Tensor,
                      acc: torch.Tensor | None = None) -> torch.Tensor:
    """blocks.correlate analog: integrate v_i v_j* over the gulp,
    ``einsum("tci,tcj->cij", x, conj(x))`` as one batched product over
    channels.

    Args:
      voltages: complex64 [T, chan, stand, pol].
      acc: complex64 [chan, stand*pol, stand*pol] to add the gulp into in
        place (no second accumulator is made), or None for a new one.

    Returns:
      complex64 [chan, stand*pol, stand*pol]: ``acc`` when given.
    """
    T, nchan, nstand, npol = voltages.shape
    x = voltages.reshape(T, nchan, nstand * npol).permute(1, 2, 0)
    with pfb_ops.full_fp32_matmul():
        if acc is None:
            return torch.bmm(x, x.mH)
        return acc.baddbmm_(x, x.mH)


def _to_host(acc: torch.Tensor) -> np.ndarray:
    """One copy of an integration to the host: into pinned memory from a
    card, as the tensor itself on the CPU."""
    if acc.device.type != "cuda":
        return acc.numpy()
    host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
    host.copy_(acc)
    return host.numpy()


def upchan_imaging_run(voltages_packed: np.ndarray, nupchan: int,
                       chan_range: tuple[int, int],
                       nframe_per_integration: int,
                       gulp_ntime: int = 480, device="cuda"):
    """Offline imaging pass: upchan -> channel select -> integrate
    visibilities (lwa352-upchan-imag.py:91-111).  An integration closes
    once it holds ``nframe_per_integration`` fine frames; a partial one is
    returned at the end.

    Returns list of integrated visibility matrices, numpy complex64
    [nchan_sel, ninput, ninput].
    """
    dev = _device(device)
    ntime = voltages_packed.shape[0]
    stage = _stage((gulp_ntime,) + voltages_packed.shape[1:], dev)
    acc = None
    nacc = 0
    out = []
    for g0 in range(0, ntime - gulp_ntime + 1, gulp_ntime):
        gulp = _gulp_to_device(voltages_packed[g0:g0 + gulp_ntime], dev,
                               stage)
        sel = upchan_select_gulp(gulp, nupchan, chan_range[0],
                                 chan_range[1])
        acc = correlate_offline(sel, acc)
        nacc += sel.shape[0]
        if nacc >= nframe_per_integration:
            out.append(_to_host(acc))
            acc, nacc = None, 0
    if acc is not None:
        out.append(_to_host(acc))
    return out
