"""PyTorch + CUDA port of the LWA-352 X-engine.

The JAX package :mod:`caltech_bifrost_dsp_tpu` stays the reference; this
package mirrors its layout module by module and imports nothing of it (it
keeps its own copies even of the modules that are plain numpy).  It
covers the fused X/B step (correlate into fast and slow int32
accumulators, baseline subselection, beamforming with power integration
and VLBI voltages), the FX path (PFB channelizer in front), the threaded
driver and its CLI, the single-controller device mesh, the wire path
(native capture in, C++ COR packetizer out), the control plane, the
transient voltage recorder, and the consumers of the products: the
offline upchannelizer pipelines that replay triggered dumps, the packet
receivers and the golden-vector CLIs.

Each hot kernel is hand-written CUDA under ``ops/kernels/csrc`` and sits
beside a plain PyTorch version of the same function.  A wrapper runs the
plain version for CPU tensors and launches its kernel for CUDA tensors.
Entry points run on the card unless the caller asks for the CPU.
"""

from .config import LWA352, XEngineConfig

__all__ = ["XEngineConfig", "LWA352"]
