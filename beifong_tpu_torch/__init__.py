"""beifong_tpu_torch: the PyTorch / CUDA port of beifong_tpu.

Runs the radar receive path on an NVIDIA H100 through hand-written CUDA
kernels (`csrc/`), with a plain PyTorch version of every kernel beside it.
Imports neither JAX nor the JAX package.  Entry points run on `cuda` unless
the caller passes `device='cpu'`, and raise when `cuda` is asked for and
there is no card.
"""

from .core.config import Band  # noqa: F401
from .receive import (receive, receive_cpi, develop_signal,  # noqa: F401
                      receive_mimo, develop_mimo)
from .scene import Scene, SceneData  # noqa: F401
from .scenes import (flagship_scene, mesh_scene,  # noqa: F401
                     multi_body_scene, range_doppler_scene,
                     fmcw_sonar_scene, fmcw_scene, pulse_train_scene,
                     fmcw_dechirp_scene, corner_scene,
                     micro_doppler_scene, mimo_beamform_scene,
                     stratified_medium_scene, phased_tx_scene,
                     phased_rx_scene, four_tx_scene, window_corner_scene,
                     plastic_scene, rough_dielectric_scene,
                     composite_scene)
