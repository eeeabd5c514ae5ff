"""beifong_tpu_torch: the PyTorch / CUDA port of beifong_tpu.

Runs the radar receive path on an NVIDIA H100 through hand-written CUDA
kernels (`csrc/`), with a plain PyTorch version of every kernel beside it.
Imports neither JAX nor the JAX package.  Entry points run on `cuda` unless
the caller passes `device='cpu'`, and raise when `cuda` is asked for and
there is no card.
"""

from .core.config import Band  # noqa: F401
from .receive import receive, develop_signal  # noqa: F401
from .scene import Scene, SceneData  # noqa: F401
from .scenes import (flagship_scene, mesh_scene,  # noqa: F401
                     multi_body_scene)
