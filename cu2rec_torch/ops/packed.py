"""Packed tables: factors and bias in one row.

    T_u[u] = [ p_u(F) | b_u | 0-pad → W ]
    T_i[i] = [ q_i(F) | b_i | 0-pad → W ]

One gather fetches an item's factors and its bias.  With ``x̂ = set_col(x,
F, 1)`` the fold-in update of a user row is one expression,

    Δrow_u = lr · (e · t̂_i − reg_u ⊙ row_u)      reg_u = [P_reg…, ub_reg, 0…]

— column F of ``t̂`` being 1 makes the bias update fall out of the factor
formula, and the padding stays zero because its reg is 0.  Same layout and
widths as the TPU package's ``ops/packed.py``.

``packed_step`` is one SGD iteration over the packed tables.  On CUDA
tensors it launches kernel K0a (``ops/cuda_sgd.py``); on CPU tensors it
runs ``packed_step_reference``, the same step in plain torch, line for
line after the TPU package's ``packed_step``.  Both are functional: they
return new tables and leave the inputs as they were.

Tables are float32 or bf16.  As in the TPU package, a bf16 table is
loaded, upcast to float32, updated in float32 and stored back rounded to
nearest even (``.to(torch.bfloat16)``, the TPU package's ``astype``).

Under ``collision="mean"`` and ``"sum"`` every sampled (user, item) pair
adds its item delta, cast to the table dtype first (``di.astype(dt)``).
The rule for colliding adds is the one XLA's scatter-add follows on the
CPU, which the tests confirm: the pairs are added in ascending user order,
and the sum is rounded to the table dtype after each add
(``scatter_add_in_order``).  In float32 that is a sequential float32 sum.
In bf16 a delta below half an ulp of the row entry is lost, as in the TPU
package.  torch's ``index_add_`` follows neither rule in bf16 on the CPU
(it rounds once), nor any fixed order on the card, so the plain version
does not call it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cu2rec_torch.models.state import MFModel
from cu2rec_torch.ops.sgd import (
    INT32_MAX, Hyper, _take, elect_winners, rotated_priority, sample_items,
    sample_positions, start_user_of,
)
from cu2rec_torch.utils.timing import count, span

COLLISIONS = ("first_wins", "twin", "mean", "sum")
# The table dtypes the step and kernels K0a, K0b take, with the kernels'
# code for each (their ``elem`` argument).
TABLE_ELEMS = {torch.float32: 0, torch.bfloat16: 1}
# The row widths kernels K0a and K0b take: packed_width(F) for F < 512.
KERNEL_WIDTHS = (64, 128, 256, 384, 512)


def check_kernel_tables(kernel: str, T_u: torch.Tensor,
                        T_i: torch.Tensor) -> None:
    """Raise unless both tables suit the kernels' float4 rows: a width in
    ``KERNEL_WIDTHS`` and a start on a 16-byte boundary."""
    W = T_u.shape[1]
    if W not in KERNEL_WIDTHS:
        raise ValueError(f"{kernel} takes rows of {KERNEL_WIDTHS} floats, "
                         f"got {W}")
    for name, t in (("T_u", T_u), ("T_i", T_i)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def packed_width(n_factors: int) -> int:
    """Smallest of 64, 128 or a multiple of 128 holding F factors + 1 bias."""
    need = n_factors + 1
    for w in (64, 128):
        if need <= w:
            return w
    return -(-need // 128) * 128


@dataclass
class PackedModel:
    """Packed parameter tables."""

    T_u: torch.Tensor        # (n_users, W)
    T_i: torch.Tensor        # (n_items, W)
    global_bias: torch.Tensor
    n_factors: int

    @property
    def width(self) -> int:
        return self.T_u.shape[1]


def _pack_side(M: torch.Tensor, b: torch.Tensor, W: int) -> torch.Tensor:
    F = M.shape[1]
    row = torch.zeros((M.shape[0], W), dtype=M.dtype, device=M.device)
    row[:, :F] = M
    row[:, F] = b.to(M.dtype)
    return row


def pack(model: MFModel) -> PackedModel:
    F = model.n_factors
    W = packed_width(F)
    return PackedModel(T_u=_pack_side(model.P, model.user_bias, W),
                       T_i=_pack_side(model.Q, model.item_bias, W),
                       global_bias=model.global_bias, n_factors=F)


def unpack(pm: PackedModel) -> MFModel:
    F = pm.n_factors
    return MFModel(P=pm.T_u[:, :F], Q=pm.T_i[:, :F],
                   user_bias=pm.T_u[:, F], item_bias=pm.T_i[:, F],
                   global_bias=pm.global_bias)


def _reg_vectors(hp: Hyper, F: int, W: int, device=None):
    """(factor mask, bias-column mask, reg_u, reg_i), each (W,) float32."""
    col = torch.arange(W, device=device)
    factor = col < F
    biascol = col == F
    zero = torch.zeros((), device=device)
    reg_u = torch.where(factor, hp.P_reg,
                        torch.where(biascol, hp.user_bias_reg, zero))
    reg_i = torch.where(factor, hp.Q_reg,
                        torch.where(biascol, hp.item_bias_reg, zero))
    return (factor.to(torch.float32), biascol.to(torch.float32),
            reg_u.to(torch.float32), reg_i.to(torch.float32))


def check_collision(collision: str) -> None:
    if collision not in COLLISIONS:
        raise ValueError(f"unknown collision policy: {collision}")


def check_step_args(pm: PackedModel, dev, train_items: bool,
                    collision: str) -> None:
    """Raise for what the step does not take."""
    if train_items:
        check_collision(collision)
    if pm.T_u.dtype not in TABLE_ELEMS or pm.T_i.dtype != pm.T_u.dtype:
        raise TypeError(f"tables must both be float32 or both bfloat16, got "
                        f"{pm.T_u.dtype} and {pm.T_i.dtype}")
    if train_items and collision == "twin" and dev.it_indptr is None:
        raise ValueError("collision='twin' needs item-major arrays: "
                         "build DeviceRatings with item_major=True")


def _item_update(T_i32, w_rows, w_rat, has_w, pm: PackedModel, hp: Hyper,
                 factor, biascol, reg_i):
    """The dense item-side update from each item's (pre-step) partner row
    ``w_rows`` and rating ``w_rat`` (packed.py:158-166 / 202-210 there)."""
    F = pm.n_factors
    ihat_d = T_i32 * factor + biascol
    uhat_w = w_rows * factor + biascol
    pred_w = (pm.global_bias + torch.sum(w_rows * ihat_d, dim=-1)
              + T_i32[:, F])
    err_w = torch.where(has_w, w_rat - pred_w, 0.0)
    di = hp.learning_rate * (err_w[:, None] * uhat_w - reg_i * T_i32)
    return torch.where(has_w[:, None], T_i32 + di, T_i32)


def scatter_add_in_order(T: torch.Tensor, idx: torch.Tensor,
                         src: torch.Tensor,
                         peak: torch.Tensor | None = None) -> torch.Tensor:
    """``T`` with ``src[k]`` added to row ``idx[k]`` one pair after another
    in the order of k, the sum rounded to ``T``'s dtype after each add (the
    rule of XLA's scatter-add on the CPU).  Pairs are taken by their rank
    among the pairs of their row, so each round adds to distinct rows.

    ``peak``, a float32 tensor of ``T``'s shape, is raised to the largest
    magnitude each entry reaches along its adds: the scale at which another
    implementation's roundings of the same chain may differ."""
    out = T.clone()
    if idx.numel() == 0:
        return out
    order = torch.sort(idx, stable=True).indices
    sidx = idx[order]
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[1:] = sidx[1:] != sidx[:-1]
    starts = torch.nonzero(first)[:, 0]
    pos = torch.arange(sidx.numel(), device=idx.device)
    rank = pos - starts[torch.cumsum(first.to(torch.int64), 0) - 1]
    by_rank = order[torch.sort(rank, stable=True).indices]
    counts = torch.bincount(rank).tolist()
    lo = 0
    for n in counts:
        sel = by_rank[lo:lo + n]
        rows = idx[sel]
        out[rows] = (out[rows].to(torch.float32)
                     + src[sel].to(torch.float32)).to(T.dtype)
        if peak is not None:
            peak[rows] = torch.maximum(peak[rows], out[rows].abs().float())
        lo += n
    return out


def collision_runs_reference(items: torch.Tensor, has: torch.Tensor,
                             n_items: int):
    """The runs of a ``mean``/``sum`` step's pairs, in plain torch:
    ``(offsets, users)``, int32.  ``offsets`` (n_items + 1,) holds each
    item's run start (the count of pairs of the items before it), so item
    i's run is ``users[offsets[i]:offsets[i + 1]]``; ``users`` lists the
    users with a pair (``has``), ordered by item and, within an item, by
    user: the order in which ``scatter_add_in_order`` adds them.  ``items``
    is the sampled item of each user (``sample_items``)."""
    users = torch.nonzero(has)[:, 0]
    keys = items[users]
    order = torch.sort(keys, stable=True).indices
    offsets = torch.zeros(n_items + 1, dtype=torch.int64, device=items.device)
    offsets[1:] = torch.cumsum(torch.bincount(keys, minlength=n_items), 0)
    return offsets.to(torch.int32), users[order].to(torch.int32)


def collision_runs(dev, key, iteration: int):
    """The runs of a ``mean``/``sum`` step at ``iteration``: K0a's counting
    sort (``cuda_sgd.collision_runs_cuda``) on CUDA ratings,
    ``collision_runs_reference`` of the step's sampled pairs on CPU ones."""
    if dev.indptr.device.type == "cpu":
        items, _ratings, has = sample_items(key, iteration, dev.indptr,
                                            dev.indices, dev.data)
        return collision_runs_reference(items, has, dev.n_items)
    from cu2rec_torch.ops.cuda_sgd import collision_runs_cuda
    return collision_runs_cuda(dev, key, iteration)


def packed_step_reference(pm: PackedModel, dev, hp: Hyper, key,
                          iteration: int, *, train_items: bool = True,
                          collision: str = "first_wins",
                          rotation: int = 250,
                          peak: torch.Tensor | None = None) -> PackedModel:
    """The plain version of K0a: one SGD iteration in plain torch, on any
    device.  Every read is of the pre-step tables, upcast to float32.
    ``peak`` (mean and sum) is ``scatter_add_in_order``'s."""
    check_step_args(pm, dev, train_items, collision)
    T_u, T_i = pm.T_u, pm.T_i
    U, W = T_u.shape
    I = T_i.shape[0]
    F = pm.n_factors
    dt = T_u.dtype
    lr = hp.learning_rate

    items, ratings, has = sample_items(key, iteration, dev.indptr,
                                       dev.indices, dev.data)
    items = torch.where(has, items, 0)
    row_i = T_i[items].to(torch.float32)                 # (U, W) pre-step
    row_u32 = T_u.to(torch.float32)

    factor, biascol, reg_u, reg_i = _reg_vectors(hp, F, W, T_u.device)
    ihat = row_i * factor + biascol
    pred = (pm.global_bias + torch.sum(row_u32 * ihat, dim=-1)
            + row_i[:, F])
    err = torch.where(has, ratings - pred, 0.0)
    du = lr * (err[:, None] * ihat - reg_u * row_u32)
    T_u_new = torch.where(has[:, None], row_u32 + du, row_u32).to(dt)
    if not train_items:
        return PackedModel(T_u=T_u_new, T_i=T_i, global_bias=pm.global_bias,
                           n_factors=F)

    if collision in ("mean", "sum"):
        # Every pair adds its delta: packed.py:214-228 there.
        uhat = row_u32 * factor + biascol
        di = lr * (err[:, None] * uhat - reg_i * row_i)
        if collision == "mean":
            counts = torch.zeros(I, dtype=torch.float32, device=T_u.device)
            counts.index_add_(0, items, has.to(torch.float32))
            di = di / torch.clamp(counts, min=1.0)[items][:, None]
        T_i_new = scatter_add_in_order(T_i, items[has], di[has].to(dt),
                                       peak)
        return PackedModel(T_u=T_u_new, T_i=T_i_new,
                           global_bias=pm.global_bias, n_factors=F)

    if collision == "first_wins":
        # Election inversion: uid = (prio + start_user) mod U, so the item
        # side is a dense map that gathers each item's winning user.
        prio = rotated_priority(U, iteration, 0, U, rotation, T_u.device)
        best, _cand = elect_winners(items, has, prio, I)
        start_user = start_user_of(iteration, U, rotation)
        has_w = best != INT32_MAX
        winner = torch.where(has_w, (best.to(torch.int64) + start_user) % U,
                             0)
        w_rows = row_u32[winner]                         # (I, W) pre-step
        w_rat = ratings[winner]
    else:
        # Twin: each item samples its own (user, rating) from the
        # item-major arrays, on the stream offset by the user count.
        pos, has_w = sample_positions(key, iteration, dev.it_indptr,
                                      user_offset=dev.n_users)
        if dev.it_order is not None:
            q = _take(dev.it_order, pos).to(torch.int64)
            s_uid, w_rat = _take(dev.row_ids, q), _take(dev.data, q)
        else:
            s_uid, w_rat = _take(dev.it_users, pos), _take(dev.it_vals, pos)
        w_rows = row_u32[torch.where(has_w, s_uid.to(torch.int64), 0)]
    T_i_new = _item_update(T_i.to(torch.float32), w_rows, w_rat, has_w, pm,
                           hp, factor, biascol, reg_i).to(dt)
    return PackedModel(T_u=T_u_new, T_i=T_i_new, global_bias=pm.global_bias,
                       n_factors=F)


def packed_step(pm: PackedModel, dev, hp: Hyper, key, iteration: int, *,
                train_items: bool = True, collision: str = "first_wins",
                rotation: int = 250, best=None, counts=None,
                mu=None) -> PackedModel:
    """One SGD iteration over packed tables (single device): kernel K0a on
    CUDA tensors, ``packed_step_reference`` on CPU tensors.  ``best`` (K0a's
    election buffer), ``counts`` (its pairs-an-item buffer under mean and
    sum) and ``mu`` (the global bias as a float, read once instead of once a
    step) are what ``packed_run_steps`` carries across steps."""
    if pm.T_u.device.type == "cpu":
        return packed_step_reference(pm, dev, hp, key, iteration,
                                     train_items=train_items,
                                     collision=collision, rotation=rotation)
    from cu2rec_torch.ops.cuda_sgd import sgd_step_cuda
    check_step_args(pm, dev, train_items, collision)
    mu = float(pm.global_bias) if mu is None else mu
    T_u, T_i = sgd_step_cuda(pm.T_u, pm.T_i, mu, dev, hp,
                             key, iteration, n_factors=pm.n_factors,
                             train_items=train_items, collision=collision,
                             rotation=rotation, best=best, counts=counts)
    return PackedModel(T_u=T_u, T_i=T_i, global_bias=pm.global_bias,
                       n_factors=pm.n_factors)


def packed_run_steps(pm: PackedModel, dev, hp: Hyper, key, start_iter: int,
                     n_steps: int, train_items: bool = True,
                     collision: str = "first_wins") -> PackedModel:
    """``n_steps`` iterations from ``start_iter``: a host loop of steps (one
    or two kernel launches each on the card, nothing synchronizes)."""
    count("sgd.steps", int(n_steps))
    with span("sgd.run_steps"):
        best = counts = mu = None
        if pm.T_u.device.type == "cuda":
            mu = float(pm.global_bias)
            I = pm.T_i.shape[0]
            if train_items and collision == "first_wins":
                best = torch.full((I,), INT32_MAX, dtype=torch.int32,
                                  device=pm.T_u.device)
            if train_items and collision in ("mean", "sum"):
                counts = torch.zeros(I, dtype=torch.int32,
                                     device=pm.T_u.device)
        for i in range(int(n_steps)):
            pm = packed_step(pm, dev, hp, key, int(start_iter) + i,
                             train_items=train_items, collision=collision,
                             best=best, counts=counts, mu=mu)
        return pm
