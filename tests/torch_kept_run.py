"""The port's served driver on the CPU with every product kept: the helper
of the tests that hold the compute loop to host truth and to JAX."""

import numpy as np
import torch

from caltech_bifrost_dsp_tpu_torch.io.sink import ProductKeeper
from caltech_bifrost_dsp_tpu_torch.runtime.driver import XEnginePipeline


def kept_pipeline(cfg, src, gains=None, pairs=None, **kw):
    """``XEnginePipeline(device="cpu")`` over ``src`` with one
    :class:`ProductKeeper` in all four sink lists.  ``gains`` (complex
    [nchan, nbeam, ninput]) and ``pairs`` (input pairs [n, 2]) are set on
    the command blocks as a coefficient load and a baseline command would
    leave them; ``kw`` goes to the pipeline.  Returns (pipeline, keeper)."""
    keeper = ProductKeeper()
    pipe = XEnginePipeline(cfg, src, corr_outputs=[keeper],
                           subsel_outputs=[keeper], pbeam_outputs=[keeper],
                           ibeam_outputs=[keeper], device="cpu", **kw)
    if gains is not None:
        pipe.beam_cmd.gains_active[...] = gains
    if pairs is not None:
        pipe.subsel_cmd.pairs_device = torch.from_numpy(
            np.asarray(pairs, np.int32))
    return pipe, keeper


def kept_run(cfg, src, ngulp: int, **kw):
    """:func:`kept_pipeline` run over ``ngulp`` gulps."""
    pipe, keeper = kept_pipeline(cfg, src, **kw)
    pipe.run(ngulp, timeout_s=300)
    return pipe, keeper
