"""Distributed serving: full-catalog scoring and top-k over an item-sharded
grid of ranks — the all_gather for a distributed top-k merge of the TPU
package's ``parallel/serving.py``.

Each rank of the grid's ``ip`` axis scores its item block (``p @ Q_loc.T``
in chunks, ``serve/engine.shard_topk``), takes a local top-k with global
ids, and the (B, k) candidates of the ranks are assembled over ``ip`` and
merged (``serve/engine.assemble_topk``): the merge moves ``n_ip × B × k``
entries instead of the (B, I) score matrix.  Every rank returns the same
result.
"""

from __future__ import annotations

import numpy as np
import torch

from cu2rec_torch.serve.engine import assemble_topk, chunk_width, shard_topk


def _on(x, device, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, dtype)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)


def distributed_topk(mesh, p_rows, ub_rows, Q, item_bias, global_bias,
                     rated_items, rated_mask, k: int = 10,
                     n_items: int | None = None):
    """Top-k over the catalog with ``Q``/``item_bias`` sharded over the
    grid's ``ip`` axis: each rank scores its block of the padded tables.

    ``p_rows`` (B, F) and the rated-item lists (B, R) are the same on every
    rank; ``Q`` must be padded to a multiple of the ip size
    (``parallel.sharded.pad_model``), and global ids at or past
    ``n_items`` (default ``Q``'s rows) are never recommended.  Returns
    (scores (B, k), item_ids (B, k)) on the rank's device with *global*
    item ids, identical to the single-device path up to score ties."""
    n_ip = mesh.n_ip
    if Q.shape[0] % n_ip:
        raise ValueError(f"Q has {Q.shape[0]} rows, not a multiple of the "
                         f"{n_ip} item shards: pad it with pad_model")
    dev = mesh.device
    I_loc = Q.shape[0] // n_ip
    off = mesh.ip_index * I_loc
    Y = _on(Q[off:off + I_loc], dev, Q.dtype)
    ib = _on(item_bias[off:off + I_loc], dev, item_bias.dtype)
    p = _on(p_rows, dev, torch.float32)
    B = p.shape[0]
    vals, ids = shard_topk(
        p, _on(ub_rows, dev, torch.float32), float(global_bias), Y, ib, off,
        Q.shape[0] if n_items is None else n_items,
        _on(rated_items, dev, torch.int64), _on(rated_mask, dev, torch.bool),
        k, chunk_width(I_loc, B, k, None))
    return assemble_topk(vals, ids, mesh.ip, mesh.ip_index, k)


def sharded_ranking_eval(mesh, model, train_csr, test_csr, k: int = 10,
                         batch_size: int = 1024,
                         max_users: int | None = None,
                         metrics: tuple = ("recall", "ndcg")) -> dict:
    """Mean top-k ranking metrics over test users, scored through the
    item-sharded serving path (the distributed counterpart of
    ``serve.recommend.ranking_eval``, which it equals in a world of one).

    ``model`` is an (unpadded) MFModel; Q/item_bias are padded to the ip
    size here and every batch runs ``distributed_topk``."""
    from cu2rec_torch.ops.topk import ndcg_at_k, recall_at_k
    from cu2rec_torch.parallel.sharded import pad_model
    from cu2rec_torch.serve.recommend import padded_user_lists

    fns = {"recall": recall_at_k, "ndcg": ndcg_at_k}
    unknown = set(metrics) - fns.keys()
    if unknown:
        raise ValueError(f"unknown ranking metric(s): {sorted(unknown)}")
    I_pad = -(-model.n_items // mesh.n_ip) * mesh.n_ip
    padded = pad_model(model, model.n_users, I_pad).to(mesh.device)

    users = np.nonzero(np.diff(test_csr.indptr) > 0)[0]
    if max_users:
        users = users[:max_users]
    if len(users) == 0:
        return {m: 0.0 for m in metrics}
    totals = {m: 0.0 for m in metrics}
    for b0 in range(0, len(users), batch_size):
        batch = users[b0:b0 + batch_size]
        rated, rmask = padded_user_lists(train_csr, batch)
        uids = torch.from_numpy(batch).to(mesh.device, torch.int64)
        _, rec = distributed_topk(
            mesh, padded.P[uids], padded.user_bias[uids], padded.Q,
            padded.item_bias, float(model.global_bias), rated, rmask, k=k,
            n_items=model.n_items)
        rel, relmask = padded_user_lists(test_csr, batch)
        rel = torch.from_numpy(rel).to(mesh.device, torch.int64)
        relmask = torch.from_numpy(relmask).to(mesh.device)
        for m in metrics:
            totals[m] += float(torch.sum(fns[m](rec, rel, relmask)))
    return {m: totals[m] / len(users) for m in metrics}


def sharded_recall_at_k(mesh, model, train_csr, test_csr, k: int = 10,
                        batch_size: int = 1024,
                        max_users: int | None = None) -> float:
    """Mean recall@k over test users through the item-sharded serving
    path (see :func:`sharded_ranking_eval`)."""
    return sharded_ranking_eval(mesh, model, train_csr, test_csr, k,
                                batch_size, max_users,
                                metrics=("recall",))["recall"]
