"""PyTorch/CUDA port of the monocular ceiling-vision SRUKF SLAM engine.

The same fixed-capacity SoA filter as ``cv_monoslam_tpu``, written as plain
functions on torch tensors, with the vision hot loop (patch warp + NCC
active search) as hand-written CUDA kernels for Hopper
(``ops/csrc/vision_kernels.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from .config import CameraConfig, SlamConfig

__version__ = "0.1.0"
__all__ = ["CameraConfig", "SlamConfig"]
