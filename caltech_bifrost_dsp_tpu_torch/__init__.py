"""PyTorch + CUDA port of the LWA-352 X-engine.

The fused X/B step of :mod:`caltech_bifrost_dsp_tpu` (correlate into fast
and slow int32 accumulators, baseline subselection, beamforming with power
integration and VLBI voltages) on an NVIDIA Hopper GPU.  The JAX package
stays the reference; this package mirrors its layout module by module and
imports nothing of it but the JAX-free ``config`` and ``runtime.arming``.

Each hot kernel is hand-written CUDA under ``ops/kernels/csrc`` and sits
beside a plain PyTorch version of the same function.  A wrapper runs the
plain version for CPU tensors and launches its kernel for CUDA tensors.
"""

from .config import LWA352, XEngineConfig

__all__ = ["XEngineConfig", "LWA352"]
