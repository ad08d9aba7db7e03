"""HDF5 sinks for the offline pipelines (port of
``caltech_bifrost_dsp_tpu/io/hdf5.py``: the same datasets, attrs and file
names; ``h5py`` is imported in each writer's constructor).

Analogs of the reference's offline output blocks
(reference: blocks/beamform_offline_output_block.py — ``HDF5FullSaveBlock``
(preallocated observation file), ``HDF5SaveBlock`` (per-beam dynamic
datasets), ``AccumHDF5SaveBlock`` (time-averaged) — and
``VisibilitySaveBlock`` at blocks/imaging_offline_output_block.py:6).
"""

from __future__ import annotations

import numpy as np


class BeamHDF5Writer:
    """Per-beam dynamic beam-voltage/power datasets
    (HDF5SaveBlock semantics)."""

    def __init__(self, path: str, nbeam: int, freqs_hz: np.ndarray,
                 dtype=np.complex64):
        import h5py

        self.fh = h5py.File(path, "w")
        self.fh.create_dataset("frequencies", data=np.asarray(freqs_hz))
        self.dsets = []
        nf = len(freqs_hz)
        for b in range(nbeam):
            self.dsets.append(self.fh.create_dataset(
                "beam%d" % b, shape=(0, nf), maxshape=(None, nf),
                dtype=dtype, chunks=(64, nf)))

    def append(self, beams: np.ndarray) -> None:
        """beams: [T, nbeam, nfreq]."""
        T = beams.shape[0]
        for b, ds in enumerate(self.dsets):
            n = ds.shape[0]
            ds.resize(n + T, axis=0)
            ds[n:] = beams[:, b]

    def close(self) -> None:
        self.fh.close()


class AccumBeamHDF5Writer:
    """Time-averaged beam powers (AccumHDF5SaveBlock semantics)."""

    def __init__(self, path: str, nbeam: int, freqs_hz: np.ndarray):
        import h5py

        self.fh = h5py.File(path, "w")
        self.fh.create_dataset("frequencies", data=np.asarray(freqs_hz))
        nf = len(freqs_hz)
        self.ds = self.fh.create_dataset(
            "power", shape=(0, nbeam, nf), maxshape=(None, nbeam, nf),
            dtype=np.float32, chunks=(16, nbeam, nf))
        self.times = self.fh.create_dataset(
            "time", shape=(0,), maxshape=(None,), dtype=np.float64)

    def append(self, power: np.ndarray, t_unix: float) -> None:
        """power: [nbeam, nfreq] one accumulated spectrum."""
        n = self.ds.shape[0]
        self.ds.resize(n + 1, axis=0)
        self.ds[n] = power
        self.times.resize(n + 1, axis=0)
        self.times[n] = t_unix

    def close(self) -> None:
        self.fh.close()


class VisibilityHDF5Writer:
    """Integrated visibilities + freq/time axes (VisibilitySaveBlock)."""

    def __init__(self, path: str, freqs_hz: np.ndarray, ninput: int):
        import h5py

        self.fh = h5py.File(path, "w")
        self.fh.create_dataset("freq", data=np.asarray(freqs_hz))
        nf = len(freqs_hz)
        self.vis = self.fh.create_dataset(
            "vis", shape=(0, nf, ninput, ninput),
            maxshape=(None, nf, ninput, ninput), dtype=np.complex64,
            chunks=(1, min(nf, 16), ninput, ninput))
        self.times = self.fh.create_dataset(
            "time", shape=(0,), maxshape=(None,), dtype=np.float64)

    def append(self, vis: np.ndarray, t_unix: float) -> None:
        n = self.vis.shape[0]
        self.vis.resize(n + 1, axis=0)
        self.vis[n] = vis
        self.times.resize(n + 1, axis=0)
        self.times[n] = t_unix

    def close(self) -> None:
        self.fh.close()


class FullObservationHDF5Writer:
    """Preallocated whole-observation file — the ``HDF5FullSaveBlock``
    analog (reference: blocks/beamform_offline_output_block.py:17-175).

    Layout mirrors the reference (an LWA "DRX-style" HDF5):
    ``Observation1`` group with observation metadata attrs (RA/Dec,
    LFFT, RBW, sampleRate, tInt, ...), ``Observation1/time`` as an
    (int, frac) compound unix/utc dataset spanning the WHOLE observation,
    and ``Observation1/Tuning1/{I, freq}`` with ``I`` preallocated to
    [total_nsamples, total_nfreq] float32.  Data from any sequence is
    scattered to its (time, freq) offsets, so multiple channel ranges /
    restarts fill one coherent file (the filename carries RA/Dec exactly
    as the reference formats it).
    """

    def __init__(self, path_prefix: str, ra: float, dec: float,
                 tstart_unix: float, tstep_s: float,
                 total_nsamples: int, sfreq_hz: float, fstep_hz: float,
                 total_nfreq: int, sample_rate_hz: float = 196e6):
        import h5py

        self.filename = "%s_%.2f_%.2f.hdf5" % (path_prefix, ra, dec)
        self.tstart_unix = tstart_unix
        self.tstep_s = tstep_s
        self.sfreq_hz = sfreq_hz
        self.fstep_hz = fstep_hz
        self.total_nsamples = total_nsamples
        self.total_nfreq = total_nfreq
        self.fh = h5py.File(self.filename, "a")
        if "Observation1" not in self.fh:
            obs = self.fh.create_group("Observation1")
            for attr, value in {
                    "ARX_Filter": -1.0, "ARX_Gain1": -1.0,
                    "ARX_Gain2": -1.0, "ARX_GainS": -1.0, "Beam": 1,
                    "DRX_Gain": -1.0, "Dec": dec,
                    "Dec_Units": "degrees", "Epoch": 2000.0,
                    "LFFT": total_nfreq, "RA": ra,
                    "RA_Units": "degrees", "RBW": fstep_hz,
                    "RBW_Units": "Hz", "TargetName": "",
                    "TrackingMode": "Unknown", "nChan": total_nfreq,
                    "sampleRate": sample_rate_hz,
                    "sampleRate_Units": "Hz", "tInt": tstep_s,
                    "tInt_Units": "s"}.items():
                obs.attrs[attr] = value
            tun = obs.create_group("Tuning1")
            tun.create_dataset("I", shape=(total_nsamples, total_nfreq),
                               dtype=np.float32, fillvalue=0)
            tun.create_dataset(
                "freq", data=(sfreq_hz
                              + fstep_hz * np.arange(total_nfreq)
                              ).astype(np.float32))
            time_dtype = np.dtype([("int", np.int64),
                                   ("frac", np.float64)])
            times = tstart_unix + np.arange(total_nsamples) * tstep_s
            tarr = np.zeros(total_nsamples, dtype=time_dtype)
            tarr["int"] = np.floor(times).astype(np.int64)
            tarr["frac"] = times - tarr["int"]
            tds = obs.create_dataset("time", data=tarr)
            tds.attrs["format"] = "unix"
            tds.attrs["scale"] = "utc"

    def write(self, intensity: np.ndarray, t_unix: float,
              sfreq_hz: float) -> None:
        """Scatter a [T, nfreq_chunk] float32 block at its time/freq
        offsets (on_sequence + on_data index arithmetic,
        reference: beamform_offline_output_block.py:138-168)."""
        ti = (t_unix - self.tstart_unix) / self.tstep_s
        t0 = int(round(ti))
        f0 = int(round((sfreq_hz - self.sfreq_hz) / self.fstep_hz))
        T, nf = intensity.shape
        ds = self.fh["Observation1/Tuning1/I"]
        # clip to the preallocated observation: a negative offset would
        # WRAP via python slicing and silently overwrite the END of the
        # dataset; an overhanging block would crash mid-observation
        nt_tot, nf_tot = ds.shape
        tcut0 = max(0, -t0)
        fcut0 = max(0, -f0)
        tcut1 = max(0, (t0 + T) - nt_tot)
        fcut1 = max(0, (f0 + nf) - nf_tot)
        if tcut0 + tcut1 >= T or fcut0 + fcut1 >= nf:
            return  # entirely outside the observation window
        ds[t0 + tcut0:t0 + T - tcut1, f0 + fcut0:f0 + nf - fcut1] = \
            intensity[tcut0:T - tcut1, fcut0:nf - fcut1]

    def close(self) -> None:
        self.fh.close()
