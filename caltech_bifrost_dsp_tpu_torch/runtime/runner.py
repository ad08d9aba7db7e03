"""Streaming runner for the fused X/B step and its FX variant.

The compute loop of ``caltech_bifrost_dsp_tpu/runtime/driver.py:878-987``
without its threads, rings, command blocks and sinks: two
:class:`IntegrationController` s decide the boundary flags, a whole fast
accumulation goes to the device in ONE step call (per-gulp fallback for a
partial accumulation), the window is uploaded from pinned host memory,
and products come back as numpy.  An optional golden checkfile gates every
slow dump by exact equality, the behaviour of the JAX
``CorrFullOutput(checkfile=...)`` (io/sink.py:164-196).

FX mode (``fx=True``) takes raw ADC gulps [ntime_gulp * 2 * nchan,
ninput] and runs :func:`..models.xengine.fx_step`.  The PFB's FIR history,
the last (ntap - 1) frames of the previous call, is carried on the host
and staged in front of each call's samples, as the JAX driver does
(driver.py:735-738): zeros at stream start and after a sequence break
(:meth:`XEngineRunner.new_sequence`), empty for ntap == 1.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import XEngineConfig
from ..models.xengine import dense_vis, fx_step, init_state, xengine_step
from ..ops import corr_subsel as cs
from ..ops.beamform import BeamGains
from ..ops.pfb import pfb_window
from .arming import Action, IntegrationController


def fx_scale(quant_scale: float, eq_gains=None) -> np.ndarray:
    """Requant gain of the FX step: ``eq_gains * quant_scale`` per channel
    (float32 product), or ``quant_scale`` alone (driver.py:197-204)."""
    scale = np.float32(quant_scale)
    if eq_gains is not None and len(eq_gains):
        return np.asarray(eq_gains, np.float32) * scale
    return np.asarray(scale)


class XEngineRunner:
    """One pipeline's device state and compute loop.

    Args:
      cfg: operating point.
      device: "cuda" (kernels) or "cpu" (plain versions).
      gains: BeamGains [nchan, nbeam, ninput]; zero gains by default, as
        the JAX driver holds before any coefficient load.
      subsel_pairs: int [nvis_out, 2] input pairs; the autos-cycling
        default selection of the reference when omitted.
      autostartat: first armed spectra index of both integrators.
      checkfile / checkfile_acc_len: golden correlation file and its
        integration length; every slow dump is compared exactly.
      fx: gulps are raw ADC samples in ``cfg.adc_dtype``.
      quant_scale / eq_gains: FX requant gain, see :func:`fx_scale`.
      adc_tail: FX FIR history to start from, [(ntap-1)*2*nchan, ninput]
        (the JAX driver's ``_adc_tail``); zeros when omitted.
    """

    def __init__(self, cfg: XEngineConfig, device="cuda",
                 gains: BeamGains | None = None, subsel_pairs=None,
                 autostartat: int = 0, checkfile: str | None = None,
                 checkfile_acc_len: int = 2400, fx: bool = False,
                 quant_scale: float = 1.0, eq_gains=None, adc_tail=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state = init_state(cfg, self.device)
        shape = (cfg.nchan, cfg.nbeam, cfg.ninput)
        if gains is None:
            gains = BeamGains(torch.zeros(shape), torch.zeros(shape))
        self.gains = BeamGains(
            *(g.to(self.device, torch.float32).contiguous() for g in gains))
        if subsel_pairs is None:
            subsel_pairs = cs.baselines_to_inputs(
                cs.default_baselines(cfg.nvis_out, cfg.nstand), cfg.npol)
        self.subsel_pairs = torch.as_tensor(
            np.asarray(subsel_pairs, dtype=np.int32)).to(self.device)
        self.fast_ctrl = IntegrationController(
            cfg.ntime_gulp, cfg.acc_len, start_time=autostartat,
            recover_margin=10)
        self.slow_ctrl = IntegrationController(
            cfg.acc_len, cfg.acc_len_slow, start_time=autostartat,
            recover_margin=2, next_boundary_start=False)
        self.checkfile = checkfile
        self.checkfile_acc_len = checkfile_acc_len
        self.check_count = 0
        self.check_failures = 0
        self.ndump_fast = 0
        self.ndump_slow = 0
        self.fx = fx
        pinned = self.device.type == "cuda"
        if fx:
            self.window = torch.from_numpy(
                pfb_window(cfg.nchan, cfg.pfb_ntap)).to(self.device)
            self.scale = torch.from_numpy(fx_scale(quant_scale, eq_gains)) \
                .to(self.device)
            shape = ((cfg.pfb_ntap - 1) * 2 * cfg.nchan, cfg.ninput)
            if adc_tail is None:
                adc_tail = np.zeros(shape, cfg.adc_np_dtype)
            if np.shape(adc_tail) != shape:
                raise ValueError(f"adc_tail must be {shape}")
            self.adc_tail = np.array(adc_tail, dtype=cfg.adc_np_dtype)
            # FIR history + one fast window of ADC, pinned
            self._staging = torch.from_numpy(np.empty(
                (shape[0] + cfg.acc_len * 2 * cfg.nchan, cfg.ninput),
                cfg.adc_np_dtype))
            if pinned:
                self._staging = self._staging.pin_memory()
        else:
            # one fast window of pinned host memory: the source of every H2D
            self._staging = torch.empty(
                (cfg.acc_len, cfg.nchan, cfg.ninput), dtype=torch.uint8,
                pin_memory=pinned)
        self._h2d_done = None

    def new_sequence(self, t: int) -> None:
        """An upstream stream break before spectra index ``t``: realign
        both integrators (driver.py:897-907) and restart the FX FIR
        history at zero, so the filter never convolves across the gap."""
        if self.fx:
            self.adc_tail = np.zeros_like(self.adc_tail)
        self.fast_ctrl.on_sequence_start(t)
        self.slow_ctrl.on_sequence_start(max(t, self.fast_ctrl.start_time))

    def run(self, stream):
        """Consume ``(t, gulp)`` pairs of one sequence (gulp uint8
        [ntime_gulp, nchan, ninput], or in FX mode ADC [ntime_gulp * 2 *
        nchan, ninput]) and yield one products dict per device call."""
        cfg = self.cfg
        fast, slow = self.fast_ctrl, self.slow_ctrl
        slow_dec = None
        batch = []
        for t, gulp in stream:
            if not batch:
                # a command to fast_ctrl lands at accumulation boundaries
                gulps_per_acc = max(1, fast.acc_len // cfg.ntime_gulp)
            dec = fast.on_gulp(t)
            if dec.action == Action.SKIP:
                continue
            if dec.is_first:
                slow_dec = slow.on_gulp(dec.seq0)
            if gulps_per_acc == 1:
                yield self._step([gulp], t, dec.is_first, dec, slow_dec)
                continue
            batch.append((t, gulp, dec))
            if dec.action != Action.DUMP:
                continue
            if len(batch) == gulps_per_acc:
                # the whole accumulation in one device call
                yield self._step([g for _, g, _ in batch], batch[0][0],
                                 True, dec, slow_dec)
            else:
                # partial accumulation: per-gulp fallback
                for tg, g, dg in batch:
                    yield self._step([g], tg, dg.is_first, dg, slow_dec)
            batch = []

    def _upload(self, gulps) -> torch.Tensor:
        """Stage ``gulps`` (behind the FIR history in FX mode) and start
        their copy to the device."""
        cfg = self.cfg
        if self._h2d_done is not None:
            # the previous upload must have left the staging memory
            self._h2d_done.synchronize()
        if self.fx:
            g = cfg.ntime_gulp * 2 * cfg.nchan
            dtype = cfg.adc_np_dtype
            head = len(self.adc_tail)
            host = self._staging[:head + len(gulps) * g]
            host[:head].copy_(torch.from_numpy(self.adc_tail))
        else:
            g = cfg.ntime_gulp
            dtype = np.uint8
            head = 0
            host = self._staging[:len(gulps) * g]
        for k, gulp in enumerate(gulps):
            host[head + k * g:head + (k + 1) * g].copy_(torch.from_numpy(
                np.ascontiguousarray(gulp, dtype=dtype)))
        if self.fx and head:
            # the last (ntap-1) frames become the next call's history
            self.adc_tail = host[len(host) - head:].numpy().copy()
        if self.device.type != "cuda":
            return host
        block = host.to(self.device, non_blocking=True)
        self._h2d_done = torch.cuda.Event()
        self._h2d_done.record()
        return block

    def _step(self, gulps, t, is_first, dec, slow_dec) -> dict:
        cfg = self.cfg
        is_dump = dec.action == Action.DUMP
        block = self._upload(gulps)
        if self.fx:
            self.state, out = fx_step(
                self.state, block, self.window, self.scale, self.gains,
                self.subsel_pairs, is_first, is_dump, slow_dec.is_first, cfg)
        else:
            self.state, out = xengine_step(
                self.state, block, self.gains, self.subsel_pairs, is_first,
                is_dump, slow_dec.is_first, cfg)
        products = {"seq0": t, "bf_power": out.bf_power.cpu().numpy(),
                    "vlbi": out.vlbi.cpu().numpy()}
        if not is_dump:
            return products
        self.ndump_fast += 1
        products["fast_seq0"] = dec.seq0
        products["acc_len"] = dec.acc_len
        products["subsel"] = (out.subsel.real.cpu().numpy(),
                              out.subsel.imag.cpu().numpy())
        if slow_dec.action == Action.DUMP:
            self.ndump_slow += 1
            v = dense_vis(self.state.vis_slow, cfg)
            vr, vi = v.real.cpu().numpy(), v.imag.cpu().numpy()
            products["vis_slow"] = (vr, vi)
            products["slow_seq0"] = slow_dec.seq0
            products["slow_acc_len"] = slow_dec.acc_len
            if self.checkfile:
                products["golden_ok"] = self.check_against_file(
                    vr, vi, slow_dec.acc_len,
                    slow_dec.seq0 // slow_dec.acc_len)
        return products

    def _load_checkfile_corr(self, t_index: int) -> np.ndarray:
        """One golden integration, looping the file."""
        cfg = self.cfg
        dim = (cfg.nchan, cfg.nstand, cfg.nstand, cfg.npol, cfg.npol)
        nbyte = int(np.prod(dim)) * 16
        fsize = os.path.getsize(self.checkfile)
        with open(self.checkfile, "rb") as fh:
            first = fh.readline()
            base = len(first) if first.startswith(b"{") else 0
            payload = fsize - base
            fh.seek(base + (nbyte * t_index) % payload)
            raw = fh.read(nbyte)
        return np.frombuffer(raw, np.complex128).reshape(dim)

    def check_against_file(self, vr: np.ndarray, vi: np.ndarray,
                           acc_len: int, t_index: int) -> bool:
        """Integrate the golden file up to ``acc_len`` and compare the dense
        slow dump exactly (io/sink.py:180-196 repetition arithmetic)."""
        if acc_len % self.checkfile_acc_len:
            raise ValueError("slow acc_len is not a multiple of the "
                             "checkfile's acc_len")
        nrep = acc_len // self.checkfile_acc_len
        t0 = t_index * nrep
        want = sum(self._load_checkfile_corr(t0 + i) for i in range(nrep))
        cfg = self.cfg
        g = want.transpose(0, 1, 3, 2, 4).reshape(cfg.nchan, cfg.ninput,
                                                  cfg.ninput)
        ok = bool(np.array_equal(g.real, vr) and np.array_equal(g.imag, vi))
        self.check_count += 1
        if not ok:
            self.check_failures += 1
        return ok
