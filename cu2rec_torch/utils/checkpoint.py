"""Checkpointing: the reference's CSV export contract and the ``.npz``
checkpoint.

The CSV contract: five component CSVs named ``{base}_f{F}_{p,q,user_bias,
item_bias,global_bias}.csv`` (mf.cu:83-87, util.cu:99-103), of which
``predict`` restores Q/item_bias/global_bias (predict.cu:110-113).

The ``.npz`` checkpoint holds the five components under the ``COMPONENTS``
keys plus a ``meta`` JSON (``{"config": ..., "extra": ...}``) — the same
keys and meta as the TPU package writes, so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from cu2rec_torch.data.ratings import load_matrix, write_component
from cu2rec_torch.models.state import MFModel, model_from_numpy, model_to_numpy
from cu2rec_torch.utils.config import Config


def export_components(model: MFModel, parent_dir: str, base: str,
                      n_factors: int) -> list[str]:
    """Write the five component CSVs (mf.cu:83-87 contract)."""
    comps = model_to_numpy(model)
    U, F = comps["p"].shape
    I = comps["q"].shape[0]
    return [
        write_component(parent_dir, base, "p", comps["p"], U, F, n_factors),
        write_component(parent_dir, base, "q", comps["q"], I, F, n_factors),
        write_component(parent_dir, base, "user_bias", comps["user_bias"],
                        U, 1, n_factors),
        write_component(parent_dir, base, "item_bias", comps["item_bias"],
                        I, 1, n_factors),
        write_component(parent_dir, base, "global_bias",
                        comps["global_bias"], 1, 1, n_factors),
    ]


def load_item_components(q_path: str, item_bias_path: str,
                         global_bias_path: str):
    """Load the serving-side components (predict.cu:110-113)."""
    Q = load_matrix(q_path)
    item_bias = load_matrix(item_bias_path).reshape(-1)
    global_bias = float(load_matrix(global_bias_path).reshape(-1)[0])
    return Q, item_bias, global_bias


def save_checkpoint(path: str, model: MFModel, cfg: Config,
                    extra: dict | None = None) -> str:
    """Write ``path`` (``.npz`` appended if missing) and return it.

    Write-then-rename: a concurrent reader, or a crash mid-write, sees
    either the previous complete checkpoint or the new one.  In a world of
    several ranks every rank calls it with the full model (the engines'
    ``finalize`` assembles it on every rank); rank 0 writes, and no rank
    returns before the file is in place, so that a rank may load it at
    once."""
    from cu2rec_torch.parallel.distributed import barrier, process_info

    final = path if path.endswith(".npz") else path + ".npz"
    rank, _world = process_info()
    if rank == 0:
        comps = model_to_numpy(model)
        meta = {"config": dataclasses.asdict(cfg), "extra": extra or {}}
        tmp = f"{final}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, meta=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **comps)
        os.replace(tmp, final)
    barrier()
    return final


def load_checkpoint(path: str, device=None):
    """Returns (model on ``device``, cfg, extra)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        model = model_from_numpy({k: z[k] for k in
                                  ("p", "q", "user_bias", "item_bias",
                                   "global_bias")}, device=device)
    names = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in meta["config"].items() if k in names})
    return model, cfg, meta.get("extra", {})
