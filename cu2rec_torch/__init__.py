"""cu2rec_torch — the PyTorch/CUDA port of the matrix-factorization engine.

A second package beside the TPU package, with the same layout and module
names, so each module here has its counterpart there.  It runs on one
NVIDIA Hopper GPU (H100): plain tensor code is PyTorch, and each kernel the
TPU package wrote in Pallas is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Every entry point takes an explicit ``device``; the default is ``cuda`` and
there is no silent fall-back to the CPU (``utils/device.py``).

Importing this package imports nothing heavy: the names of ``__all__`` load
their modules at first access (a module ``__getattr__``), each submodule
imports torch itself, and nothing is built or launched at import time.
"""

import importlib

__version__ = "0.1.0"

# Each top-level name and the module that defines it.
_HOMES = {
    "Config": "cu2rec_torch.utils.config",
    "MFModel": "cu2rec_torch.models.state",
    "init_model": "cu2rec_torch.models.state",
    "train": "cu2rec_torch.train.trainer",
    "train_als": "cu2rec_torch.train.als",
    "train_bpr": "cu2rec_torch.train.bpr",
    "train_ials": "cu2rec_torch.train.ials",
    "read_ratings_csv": "cu2rec_torch.data.ratings",
    "build_csr": "cu2rec_torch.data.csr",
    "CSRRatings": "cu2rec_torch.data.csr",
}

__all__ = [*_HOMES, "__version__"]


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(home), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted({*globals(), *__all__})
