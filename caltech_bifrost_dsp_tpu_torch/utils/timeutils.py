"""Wall-clock <-> spectra-index arithmetic (port of
``caltech_bifrost_dsp_tpu/utils/timeutils.py``).

Used to align the arming of several pipelines: each converts a future UNIX
time to a spectra index (counted from the sync event) and rounds it down
to an integration boundary, so integrations stay phase-aligned across the
array (reference: pipeline-control/lwa352_pipeline_control/
lwa352_utils.py:5-23 and blocks/corr_control.py:36-67).
"""

from __future__ import annotations

from ..config import FENGINE_NCHAN, FS_HZ


def time_to_spectra(t: float, fs_hz: int = FS_HZ,
                    fengine_nchan: int = FENGINE_NCHAN) -> int:
    """UNIX time -> spectra count since the UNIX epoch."""
    sample_number = int(t * fs_hz)
    return sample_number // (2 * fengine_nchan)


def spectra_to_time(s: int, fs_hz: int = FS_HZ,
                    fengine_nchan: int = FENGINE_NCHAN) -> float:
    """Spectra count since the UNIX epoch -> UNIX time."""
    return (s * 2 * fengine_nchan) / fs_hz


def next_allowed_start(now: float, delay_s: float, sync_time: float,
                       spectra_rate_hz: float, granularity: int) -> int:
    """Spectra index of an allowed integration start ~``delay_s`` in the
    future, rounded down to a multiple of ``granularity`` (the gulp or
    accumulation quantum; reference: blocks/corr_control.py:55-66)."""
    spectra_delay = (now + delay_s - sync_time) * spectra_rate_hz
    return int(spectra_delay) - (int(spectra_delay) % granularity)
