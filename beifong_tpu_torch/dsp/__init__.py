"""The signal chain on `torch` (counterpart of `beifong_tpu/dsp`)."""

from .cfar import ca_cfar_2d  # noqa: F401
