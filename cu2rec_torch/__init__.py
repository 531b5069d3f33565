"""cu2rec_torch — the PyTorch/CUDA port of the matrix-factorization engine.

A second package beside the TPU package, with the same layout and module
names, so each module here has its counterpart there.  It runs on one
NVIDIA Hopper GPU (H100): plain tensor code is PyTorch, and each kernel the
TPU package wrote in Pallas is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Every entry point takes an explicit ``device``; the default is ``cuda`` and
there is no silent fall-back to the CPU (``utils/device.py``).

Importing this package imports nothing heavy: each submodule imports torch
itself, and nothing is built or launched at import time.
"""

__version__ = "0.1.0"
