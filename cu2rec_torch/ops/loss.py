"""RMSE/MAE evaluation — the reference's loss path (loss.cu).

The reference computes a per-rating error with a one-thread-per-user kernel
walking each CSR slice (loss.cu:19-35) and reduces it with a shared-memory
tree (loss.cu:58-128), finishing the sum on the CPU.  As in the TPU
package, the ragged walk becomes a flat gather over the ``row_ids``
expansion.  Over packed tables the error and both sums are one kernel on
the card, K0b (``ops/cuda_loss.py``); on the CPU the same sums run in plain
torch (``packed_error_sums_reference``), chunked to bound memory.  Both
take the error in float32 and sum in float64, in a fixed order, so an eval
gives the same value every time it runs.

The TPU package's windowed user-row path (a VMEM trick) has no counterpart:
the sums are the same without it.  Over unpacked tables (the unpacked
step's engine) the eval is ``error_sums``, plain torch on either device.
"""

from __future__ import annotations

import math

import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.utils.timing import count, span


# Ratings a chunk of the plain eval, before the width cap.
EVAL_CHUNK = 1 << 20


def _sums(err: torch.Tensor):
    e = err.to(torch.float64)
    return torch.sum(e * e), torch.sum(torch.abs(e))


def _cap_eval_chunk(chunk_size: int, width: int) -> int:
    """Width-aware eval chunk: each chunk's gathered rows stay near 512 MiB
    a table (the TPU package's bound; F <= 128 keeps 1 Mi rows)."""
    cap = (512 << 20) // max(width * 4, 1)
    if cap >= chunk_size:
        return chunk_size
    return max((cap // 16384) * 16384, 16384)


def packed_error_sums_reference(T_u, T_i, mu, rows, cols, vals,
                                n_factors: int,
                                chunk_size: int = EVAL_CHUNK) -> torch.Tensor:
    """The plain version of K0b: (Σerr², Σ|err|) as a float64 (2,) tensor,
    on any device, in chunks of ``chunk_size`` ratings; float32 or bf16
    tables, their rows upcast to float32."""
    F = n_factors
    W = T_u.shape[1]
    col = torch.arange(W, device=T_u.device)
    factor = (col < F).to(torch.float32)
    biascol = (col == F).to(torch.float32)
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    out = torch.zeros(2, dtype=torch.float64, device=T_u.device)
    for s in range(0, rows.shape[0], chunk_size):
        sl = slice(s, s + chunk_size)
        ru = T_u[rows[sl]].to(torch.float32)
        ri = T_i[cols[sl]].to(torch.float32)
        ihat = ri * factor + biascol
        pred = mu + torch.sum(ru * ihat, dim=-1) + ri[:, F]
        a, b = _sums(vals[sl] - pred)
        out += torch.stack([a, b])
    return out


def packed_error_sums(pm, dev) -> torch.Tensor:
    """(Σerr², Σ|err|) over the first ``dev.nnz`` ratings: K0b on CUDA
    tensors, its plain version on CPU tensors."""
    n = dev.nnz
    rows, cols, vals = dev.row_ids[:n], dev.indices[:n], dev.data[:n]
    if pm.T_u.device.type == "cpu":
        return packed_error_sums_reference(
            pm.T_u, pm.T_i, pm.global_bias, rows, cols, vals, pm.n_factors,
            _cap_eval_chunk(EVAL_CHUNK, pm.width))
    from cu2rec_torch.ops.cuda_loss import packed_error_sums_cuda
    return packed_error_sums_cuda(pm.T_u, pm.T_i, float(pm.global_bias),
                                  rows, cols, vals, pm.n_factors)


def pairwise_errors(P, Q, user_bias, item_bias, global_bias, rows, cols,
                    vals):
    """error[k] = rating[k] − r̂(u_k, i_k), in float32 (loss_kernel,
    loss.cu:29-33)."""
    rows, cols = rows.to(torch.int64), cols.to(torch.int64)
    pred = (global_bias + user_bias[rows].to(torch.float32)
            + item_bias[cols].to(torch.float32)
            + torch.sum(P[rows].to(torch.float32)
                        * Q[cols].to(torch.float32), dim=-1))
    return vals - pred


def error_sums(P, Q, user_bias, item_bias, global_bias, rows, cols, vals,
               mask, chunk_size: int = EVAL_CHUNK) -> torch.Tensor:
    """(Σerr², Σ|err|) over the ratings where ``mask`` holds, as a float64
    (2,) tensor, in chunks of ``chunk_size`` ratings: the TPU package's
    ``error_sums`` over unpacked tables."""
    out = torch.zeros(2, dtype=torch.float64, device=P.device)
    for s in range(0, rows.shape[0], chunk_size):
        sl = slice(s, s + chunk_size)
        err = pairwise_errors(P, Q, user_bias, item_bias, global_bias,
                              rows[sl], cols[sl], vals[sl])
        a, b = _sums(torch.where(mask[sl], err, 0.0))
        out += torch.stack([a, b])
    return out


def evaluate_unpacked(model: MFModel, dev, chunk_size: int = EVAL_CHUNK):
    """(RMSE, MAE) of unpacked tables over the first ``dev.nnz`` ratings
    of a ``DeviceRatings`` set (``error_sums``)."""
    n = dev.nnz
    mask = torch.ones(n, dtype=torch.bool, device=dev.indices.device)
    return _metrics(error_sums(model.P, model.Q, model.user_bias,
                               model.item_bias, model.global_bias,
                               dev.row_ids[:n], dev.indices[:n],
                               dev.data[:n], mask, chunk_size), n)


def _metrics(sums: torch.Tensor, nnz: int):
    with span("eval.wait"):
        sse, sae = (float(x) for x in sums.cpu())
    return math.sqrt(sse / nnz), sae / nnz


def evaluate_packed(pm, dev):
    """(RMSE, MAE) of packed tables over a ``DeviceRatings`` set; the
    denominator is the true rating count ``dev.nnz``."""
    count("eval.calls")
    with span("eval"):
        return _metrics(packed_error_sums(pm, dev), dev.nnz)


def evaluate(model: MFModel, dev):
    """(RMSE, MAE) of a model over a ratings set — ``calculate_loss_gpu`` +
    ``get_error_metrics_gpu`` (loss.cu:40-49, 150-200).  The tables are
    packed first, so on the card this is K0b too."""
    from cu2rec_torch.ops.packed import pack
    return evaluate_packed(pack(model), dev)


def metrics_from_errors(errors: torch.Tensor):
    """(MAE, RMSE) from a per-rating error vector (get_error_metrics,
    loss.cu:132-143)."""
    n = errors.shape[0]
    sse, sae = _sums(errors)
    return float(sae) / n, math.sqrt(float(sse) / n)
