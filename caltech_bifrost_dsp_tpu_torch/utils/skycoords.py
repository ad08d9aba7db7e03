"""Sky-coordinate utilities for offline beam pointing (port of
``caltech_bifrost_dsp_tpu/utils/skycoords.py``, line for line, so that both
packages give bit-equal angles).

The reference points offline beams with astropy's ICRS->AltAz machinery
(reference: blocks/beamform_offline_block.py:73-97 ``set_beam_target``).
astropy is used when importable; otherwise an equivalent pure-numpy
transformation (apparent sidereal-time based, arcminute-level accuracy,
ample for beam pointing) stands in.
"""

from __future__ import annotations

import math

SPEED_OF_LIGHT = 299_792_458.0  # m/s


def unix_to_jd(t: float) -> float:
    return t / 86400.0 + 2440587.5


def gmst_deg(t_unix: float) -> float:
    """Greenwich mean sidereal time in degrees (IAU 1982-style poly)."""
    d = unix_to_jd(t_unix) - 2451545.0
    return (280.46061837 + 360.98564736629 * d) % 360.0


def radec_to_altaz(ra_deg: float, dec_deg: float, t_unix: float,
                   lat_deg: float, lon_deg: float) -> tuple[float, float]:
    """ICRS RA/Dec -> (az, alt) in radians at a site (east longitude).

    Uses astropy when available (matching the reference exactly), else the
    numpy fallback.
    """
    try:
        import astropy.units as u
        from astropy.coordinates import (AltAz, Angle, EarthLocation,
                                         SkyCoord)
        from astropy.time import Time

        obs = EarthLocation.from_geodetic(lon=lon_deg * u.deg,
                                          lat=lat_deg * u.deg)
        sc = SkyCoord(Angle(ra_deg, unit=u.deg),
                      Angle(dec_deg, unit=u.deg), frame="icrs")
        aa = sc.transform_to(AltAz(
            obstime=Time(t_unix, format="unix", scale="utc"),
            location=obs))
        return aa.az.to(u.rad).value, aa.alt.to(u.rad).value
    except ImportError:
        pass
    lst = math.radians((gmst_deg(t_unix) + lon_deg) % 360.0)
    ra = math.radians(ra_deg)
    dec = math.radians(dec_deg)
    lat = math.radians(lat_deg)
    ha = lst - ra
    sin_alt = (math.sin(lat) * math.sin(dec)
               + math.cos(lat) * math.cos(dec) * math.cos(ha))
    alt = math.asin(max(-1.0, min(1.0, sin_alt)))
    az = math.atan2(-math.cos(dec) * math.sin(ha),
                    math.sin(dec) * math.cos(lat)
                    - math.cos(dec) * math.sin(lat) * math.cos(ha))
    return az % (2 * math.pi), alt


def pointing_to_direction(az: float, alt: float):
    """(az, alt) radians -> ENZ unit vector (east, north, up)
    (reference: beamform_offline_block.py:129-131)."""
    import numpy as np

    return np.array([math.cos(alt) * math.sin(az),
                     math.cos(alt) * math.cos(az),
                     math.sin(alt)])


def geometric_delays_s(enz_positions, az: float, alt: float):
    """Per-antenna geometric delay (seconds), referenced so the farthest
    antenna has zero delay — the reference's ``delays.max() - delays``
    convention (beamform_offline_block.py:126-137).

    Args:
      enz_positions: [nant, 3] east/north/up positions in meters.
    """
    import numpy as np

    enz = np.asarray(enz_positions, dtype=np.float64)
    zenith = np.array([0.0, 0.0, 1.0])
    direction = pointing_to_direction(az, alt)
    zenith_delay = enz @ zenith / SPEED_OF_LIGHT
    direction_delay = enz @ direction / SPEED_OF_LIGHT
    delays = direction_delay - zenith_delay
    return delays.max() - delays
