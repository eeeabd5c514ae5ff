from .waveform import Waveform, cw, pulse, linfmcw, stack  # noqa: F401
from .endpoints import (ADCConfig, wigner_transmitter,  # noqa: F401
                        wigner_receiver, omni_receiver)
