"""Runtime band configuration (counterpart of `beifong_tpu/core/config.py`).

The band is a plain frozen dataclass of Python floats: it is scene
metadata, read on the host when the scene is packed, never a tensor.
Units are SI: wavelength [m], frequency [Hz], speed [m/s].
"""

from __future__ import annotations

import dataclasses

from . import math as m


@dataclasses.dataclass(frozen=True)
class Band:
    """Propagation band: speed, wavelength extents, per-bounce phase shift
    (`boundary_phase`: 0 for sound, pi for EM reflections)."""

    c: float = m.C_AIR_SOUND
    wavelength_min: float = m.C_AIR_SOUND / 45e3
    wavelength_max: float = m.C_AIR_SOUND / 35e3
    boundary_phase: float = 0.0

    @property
    def freq_min(self) -> float:
        return self.c / self.wavelength_max

    @property
    def freq_max(self) -> float:
        return self.c / self.wavelength_min

    @property
    def freq_centre(self) -> float:
        return 0.5 * (self.freq_min + self.freq_max)

    @property
    def wavelength_centre(self) -> float:
        return 0.5 * (self.wavelength_min + self.wavelength_max)

    @staticmethod
    def from_freq(c: float, f_centre: float, f_ext: float,
                  boundary_phase: float = 0.0) -> "Band":
        lo, hi = f_centre - 0.5 * f_ext, f_centre + 0.5 * f_ext
        return Band(c=c, wavelength_min=c / hi, wavelength_max=c / lo,
                    boundary_phase=boundary_phase)


ULTRASOUND_40K = Band.from_freq(m.C_AIR_SOUND, 40e3, 10e3)
