"""Packets in and out of the pipeline (port of ``caltech_bifrost_dsp_tpu/io``).

- :mod:`.packets`: the wire formats (snap2 in; CorrFull, COR/Mark5C,
  CorrPart, PBEAM, IBEAM out).
- :mod:`.source`: the synthetic sources and :class:`.source.UdpSnap2Source`,
  the pure-Python snap2 reassembler.
- :mod:`.native`: the C++ engine built from ``native/`` at first use:
  UDP capture (``NativeCapture``, ``CaptureSource``, ``AdcCaptureSource``),
  the COR packetizers and the snap2 blaster.
- :mod:`.sink`: the product sinks; ``CorrFullOutput(native_dest=...)``
  sends through the C++ packetizer.
"""
