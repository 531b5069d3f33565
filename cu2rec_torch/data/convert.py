"""CSV float matrices → .npy (reference preprocessing/convert_to_np.py)."""

from __future__ import annotations

import os

import numpy as np

from cu2rec_torch.data.ratings import load_matrix


def save_as_npy(csv_path: str, npy_path: str | None = None) -> str:
    if npy_path is None:
        npy_path = os.path.splitext(csv_path)[0] + ".npy"
    np.save(npy_path, load_matrix(csv_path))
    return npy_path
