"""Unified, validated system configuration (the port's own copy of
``caltech_bifrost_dsp_tpu/config.py``: same fields, defaults, named
configurations and validation errors; ``tests/test_torch_config.py`` holds
the two together).

The reference spreads its configuration over three tiers: xGPU compile-time
constants (reference: install_xgpu.sh:5), script-level constants
(reference: pipeline/scripts/lwa352-pipeline.py:163-180) and runtime etcd
command keys (reference: pipeline/lwa352_pipeline/blocks/block_base.py:162-192).
Here the first two tiers are unified into one frozen dataclass; the third
tier keeps its reference semantics in
:mod:`caltech_bifrost_dsp_tpu_torch.control`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# System constants (reference: pipeline-control/lwa352_pipeline_control/
# lwa352_utils.py:1-3 and pipeline/lwa352_pipeline/blocks/capture_block.py:165)
FS_HZ = 196_000_000          # ADC sample rate in Hz
FENGINE_NCHAN = 4096         # Channels produced by the F-engine PFB
CHAN_BW_HZ = 23925.78125     # = FS_HZ / (2 * FENGINE_NCHAN)
SPECTRA_RATE_HZ = FS_HZ / (2 * FENGINE_NCHAN)  # ~23.926 kHz


@dataclass(frozen=True)
class XEngineConfig:
    """One pipeline's operating point.

    Defaults mirror the production constants in
    reference: pipeline/scripts/lwa352-pipeline.py:163-180.
    """

    nstand: int = 352            # antenna stands
    npol: int = 2                # polarizations per stand
    nchan: int = 192             # channels owned by this pipeline
    ntime_gulp: int = 480        # samples per compute gulp (xGPU NTIME)
    acc_len: int = 2400          # fast-corr accumulation (~100 ms)
    acc_len_slow: int = 240_000  # slow-corr accumulation (~10 s)
    nbeam: int = 32              # single-pol voltage beams (16 dual-pol)
    ntime_sum: int = 24          # beam-power integration length
    nchan_sum: int = 4           # subsel channel-averaging factor
    npipeline: int = 32          # frequency-shard count across the system
    pipeline_id: int = 0         # this pipeline's global index
    fs_hz: float = FS_HZ
    chan_bw_hz: float = CHAN_BW_HZ
    # PFB channelizer (new first-class component; the reference's 4096-chan
    # channelizer lives in FPGA gateware outside the repo, and its offline
    # 32x upchannelizer is a plain blockwise FFT,
    # reference: pipeline/scripts/lwa352-upchan-bf.py:94-97).
    pfb_ntap: int = 4
    nupchan: int = 32            # fine channels per coarse channel (offline)
    # Engine names are the reference's, kept so that one configuration
    # drives both packages.  Correlator: "xla" and "pallas_blk" run the
    # correlator with the accumulator algebra fused in (corr_acc.cu);
    # "pallas_triu" the gulp correlator over upper 128-tiles
    # (corr_triu.cu) with the algebra applied by the step.  On a device
    # mesh every shard runs a gulp correlator: "pallas_blk" corr_blk.cu,
    # "pallas_triu" corr_triu.cu, "xla" the plain version.
    corr_engine: str = "xla"
    # Beamformer engine: "xla" or "pallas"; both names run the one fused
    # beamformer kernel (beamform_products.cu).
    bf_engine: str = "xla"
    # Subselection engine: "bands", "xla" or "pallas"; every name runs
    # the one gather (subsel_gather.cu).  All bit-identical.
    subsel_engine: str = "bands"
    # PFB spectral transform: "fft" or "matmul"; both take the one
    # channelizer (pfb_quantize.cu, a real DFT on fp32 FMA).
    pfb_fft_impl: str = "fft"
    # DFT matmul precision: "high" (3-pass bf16, ~1e-6 relative) or
    # "bf16" (1-pass, ~1e-2 — the error class of a fixed-point FPGA
    # F-engine's coefficients, inside the 4-bit requantizer's step)
    pfb_precision: str = "high"
    # Channelizer engine for the matmul path: "xla" or "pallas" (one
    # fused FIR+DFT+requant kernel serves both)
    pfb_engine: str = "xla"
    # FX-mode raw ADC sample dtype: "float32" or "int8".  The physical
    # ADC is 8 bits (reference digitizers; SURVEY.md F-engine input),
    # so int8 is the production-faithful choice AND quarters every
    # ADC-sized data motion: host staging, H2D, the PFB kernel's HBM
    # read, and the sharded halo exchange.  int8 -> f32 is exact, so
    # products are bit-identical to feeding the same values as f32.
    adc_dtype: str = "float32"

    def __post_init__(self):
        if self.acc_len % self.ntime_gulp != 0:
            raise ValueError(
                "acc_len must be a multiple of ntime_gulp "
                f"({self.acc_len} % {self.ntime_gulp} != 0)")
        if self.acc_len_slow % self.acc_len != 0:
            raise ValueError(
                "acc_len_slow must be a multiple of acc_len "
                f"({self.acc_len_slow} % {self.acc_len} != 0)")
        if self.ntime_gulp % self.ntime_sum != 0:
            raise ValueError("ntime_gulp must be a multiple of ntime_sum")
        if self.nchan % self.nchan_sum != 0:
            raise ValueError("nchan must be a multiple of nchan_sum")
        if self.nstand % 4 != 0:
            # Required by the xGPU register-tile order emulation
            # (reference: pipeline/lwa352_pipeline/blocks/corr_block.py:37-58).
            raise ValueError("nstand must be a multiple of 4")
        if self.nbeam % 2 != 0:
            raise ValueError("nbeam must be even (beams pair into X/Y pols)")
        if self.corr_engine not in ("xla", "pallas_triu", "pallas_blk"):
            raise ValueError(f"unknown corr_engine {self.corr_engine!r}")
        if self.bf_engine not in ("xla", "pallas"):
            raise ValueError(f"unknown bf_engine {self.bf_engine!r}")
        if self.subsel_engine not in ("xla", "pallas", "bands"):
            raise ValueError(
                f"unknown subsel_engine {self.subsel_engine!r}")
        if self.pfb_fft_impl not in ("fft", "matmul"):
            raise ValueError(
                f"unknown pfb_fft_impl {self.pfb_fft_impl!r}")
        if self.pfb_precision not in ("high", "bf16"):
            raise ValueError(
                f"unknown pfb_precision {self.pfb_precision!r}")
        if self.pfb_engine not in ("xla", "pallas"):
            raise ValueError(f"unknown pfb_engine {self.pfb_engine!r}")
        if self.pfb_engine == "pallas" and self.pfb_fft_impl != "matmul":
            # kept from the reference, where only the matmul channelizer
            # dispatches on pfb_engine
            raise ValueError("pfb_engine='pallas' requires "
                             "pfb_fft_impl='matmul' (the fused kernel "
                             "is a matmul-DFT channelizer)")
        if self.adc_dtype not in ("float32", "int8"):
            raise ValueError(f"unknown adc_dtype {self.adc_dtype!r}")

    # ---- derived quantities -------------------------------------------------

    @property
    def ninput(self) -> int:
        """Total correlator inputs (stand-pols)."""
        return self.nstand * self.npol

    @property
    def system_nchan(self) -> int:
        """Channels across all frequency-sharded pipelines
        (reference: lwa352-pipeline.py:179)."""
        return self.nchan * self.npipeline

    @property
    def spectra_rate_hz(self) -> float:
        return self.fs_hz / (2 * FENGINE_NCHAN)

    @property
    def matlen(self) -> int:
        """xGPU triangular-order matrix length in complex words
        (reference: corr_block.py:231)."""
        return (self.nchan * (self.nstand // 2 + 1) * (self.nstand // 4)
                * self.npol * self.npol * 4)

    @property
    def nvis_out(self) -> int:
        """Subselected visibility count: 48 dual-pol stands' full matrix
        (reference: corr_subsel_block.py:185)."""
        return 48 * 49 * 4 // 2

    @property
    def nbaseline(self) -> int:
        """Stand pairs including autos."""
        return self.nstand * (self.nstand + 1) // 2

    @property
    def gulp_nbyte(self) -> int:
        """Bytes per input gulp of packed 4+4-bit samples."""
        return self.ntime_gulp * self.nchan * self.ninput

    @property
    def adc_np_dtype(self):
        """FX-mode raw ADC numpy dtype (np.float32 or np.int8)."""
        import numpy as np

        return np.dtype(self.adc_dtype)

    @property
    def input_gbps(self) -> float:
        """Real-time input rate this pipeline must sustain, Gb/s
        (reference implied rate, BASELINE.md)."""
        return self.nchan * self.ninput * self.spectra_rate_hz * 8 / 1e9

    @property
    def chan0(self) -> int:
        """First (global) channel this pipeline owns."""
        return self.pipeline_id * self.nchan

    @property
    def sfreq_hz(self) -> float:
        """Center frequency of this pipeline's first channel."""
        return self.chan0 * self.chan_bw_hz

    def replace(self, **kw) -> "XEngineConfig":
        return dataclasses.replace(self, **kw)


#: The production LWA-352 operating point.
LWA352 = XEngineConfig()

#: The reference's production engine selection, the CLI's ``auto``
#: defaults: ONE source of truth shared by the smoke run and the pipeline
#: CLI.  Name kept from the reference.
TPU_ENGINES = dict(corr_engine="pallas_blk", bf_engine="pallas",
                   subsel_engine="bands")

#: LWA352 with the production engines applied.
LWA352_TPU = LWA352.replace(**TPU_ENGINES)


#: Reduced configs used by the test suite and the staged benchmarks
#: (BASELINE.json "configs").
TINY = XEngineConfig(nstand=16, nchan=16, ntime_gulp=48, acc_len=240,
                     acc_len_slow=480, nbeam=4, ntime_sum=12, nchan_sum=4,
                     npipeline=2)
CPU_REF = XEngineConfig(nstand=16, nchan=64, ntime_gulp=120, acc_len=240,
                        acc_len_slow=480, nbeam=8, ntime_sum=24, nchan_sum=4,
                        npipeline=2)
SINGLE_CHIP_SMALL = XEngineConfig(nstand=32, nchan=192, ntime_gulp=480,
                                  acc_len=2400, acc_len_slow=240_000,
                                  nbeam=16)
