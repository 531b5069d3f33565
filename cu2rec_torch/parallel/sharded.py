"""Multi-device sharded SGD training over a (dp × ip) grid of ranks.

The TPU package's ``parallel/sharded.py`` is one controller over a
``Mesh(('dp', 'ip'))``.  Here each device is a process of a
``torch.distributed`` world (``parallel/distributed.py``), and the grid is
the world laid out row-major, as the TPU package's
``devices.reshape(n_dp, n_ip)``: rank ``d·n_ip + i`` holds grid cell
(d, i).  The layout is that package's:

* the user axis shards over ``dp``: each dp shard owns a contiguous block
  of users, their packed rows (factors and bias) and their CSR slices;
* the item axis shards over ``ip``: the packed item table is row-sharded
  by item (replicated at ``ip = 1``, the right choice at MovieLens and
  Netflix catalog sizes).

Its collectives, as ``all_reduce`` over the grid's two axes:

* the sampled item rows are assembled over ``ip`` (each ip shard writes
  the rows it owns, zero elsewhere, and a SUM over ``ip`` completes them);
* first_wins elects each item's winner by a local scatter-min of the
  rotated priority and a MIN over ``dp``;
* the item deltas are scattered into a dense local (I/ip, W) float32
  buffer and summed over ``dp``, so every replica applies the same update
  with one rounding to the table dtype;
* the eval's partial sums are summed over ``dp``.

The sampling streams and the election are counter functions of global ids,
so the sampled items and the winners are those of a one-device run bit for
bit; the tables agree within float tolerance (the adds happen in another
order, and the delta and the add are separate roundings).

On CPU tensors the step is ``_local_step_packed``, plain torch line for
line after the TPU package's.  On the card it is kernel K0a split at the
collectives (``ops/cuda_sgd.sgd_step_sharded_cuda``), and the eval is K0b
on each shard's ratings against the assembled item table.  The TPU
package's windowed eval (a VMEM trick) has no counterpart.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from cu2rec_torch.data.csr import (
    CSRRatings, DeviceRatings, normalize_csr_dims, transpose_csr,
)
from cu2rec_torch.models.state import (
    MFModel, init_model, table_dtype, with_dtype,
)
from cu2rec_torch.ops.loss import (
    EVAL_CHUNK, _cap_eval_chunk, packed_error_sums_reference,
)
from cu2rec_torch.ops.packed import (
    PackedModel, _reg_vectors, check_collision, pack, scatter_add_in_order,
    unpack,
)
from cu2rec_torch.ops.sgd import (
    INT32_MAX, Hyper, _take, prng_key, rotated_priority, sample_items,
    sample_positions,
)
from cu2rec_torch.parallel.distributed import (
    WORLD_OF_ONE, Axis, local_device, process_info, world_axis,
)
from cu2rec_torch.utils.config import Config
from cu2rec_torch.utils.device import resolve_device


@dataclass
class Mesh:
    """This rank's place in the (dp × ip) grid: the grid's shape, the
    rank, its device, and the axes it reduces over — ``dp`` (the ranks of
    its grid column: same ip, every dp), ``ip`` (its grid row) and the
    whole world."""

    n_dp: int
    n_ip: int
    rank: int
    device: torch.device
    dp: Axis
    ip: Axis
    world: Axis

    @property
    def shape(self) -> dict:
        return {"dp": self.n_dp, "ip": self.n_ip}

    @property
    def size(self) -> int:
        return self.n_dp * self.n_ip

    @property
    def dp_index(self) -> int:
        return self.rank // self.n_ip

    @property
    def ip_index(self) -> int:
        return self.rank % self.n_ip


def make_mesh(n_dp: int, n_ip: int = 1, device=None) -> Mesh:
    """The (n_dp × n_ip) grid over this ``torch.distributed`` world, which
    must hold n_dp·n_ip ranks (a grid of one needs no world).  Every rank
    calls it, and every rank creates every group, in the same order.
    ``device`` defaults to the one ``launch``/``initialize`` gave the rank,
    else the CUDA device."""
    import torch.distributed as dist

    rank, world = process_info()
    if n_dp < 1 or n_ip < 1 or world != n_dp * n_ip:
        raise ValueError(f"a {n_dp}x{n_ip} grid needs {n_dp * n_ip} ranks, "
                         f"the world has {world}")
    dev = resolve_device(device if device is not None else local_device())
    if world == 1:
        return Mesh(1, 1, 0, dev, WORLD_OF_ONE, WORLD_OF_ONE, WORLD_OF_ONE)
    d_me, i_me = rank // n_ip, rank % n_ip
    ip_axis = dp_axis = WORLD_OF_ONE
    if n_ip > 1:
        for d in range(n_dp):
            g = dist.new_group([d * n_ip + i for i in range(n_ip)])
            if d == d_me:
                ip_axis = Axis(g, n_ip)
    if n_dp > 1:
        for i in range(n_ip):
            g = dist.new_group([d * n_ip + i for d in range(n_dp)])
            if i == i_me:
                dp_axis = Axis(g, n_dp)
    return Mesh(n_dp, n_ip, rank, dev, dp_axis, ip_axis, world_axis())


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _put(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)


@dataclass
class ShardedRatings:
    """Ratings sharded by user block: the dp shards' local CSRs stacked,
    as host arrays (each rank uploads its own shard with ``local``).

    ``indptr`` (n_dp, U_loc + 1) rebased a shard; ``indices``, ``data``
    and ``row_ids`` (n_dp, NNZ_loc) padded to the largest shard's count;
    ``nnz`` (n_dp,) the true counts; ``row_ids`` are local user offsets,
    ``indices`` global item ids."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    row_ids: np.ndarray
    nnz: np.ndarray
    total_nnz: int
    n_users_padded: int
    n_items_padded: int

    def local(self, d: int, device) -> DeviceRatings:
        """Shard ``d`` as a ``DeviceRatings`` of U_loc users on
        ``device`` (item ids global, over the padded catalog)."""
        n = int(self.nnz[d])
        return DeviceRatings(
            indptr=_put(self.indptr[d], np.int32, device),
            indices=_put(self.indices[d, :n], np.int32, device),
            data=_put(self.data[d, :n], np.float32, device),
            row_ids=_put(self.row_ids[d, :n], np.int32, device), nnz=n,
            n_users=self.indptr.shape[1] - 1,
            n_items=self.n_items_padded)


def shard_ratings(csr: CSRRatings, n_dp: int, n_ip: int = 1,
                  mesh: Mesh | None = None) -> ShardedRatings:
    """Host-side stratification of a CSR into dp user-block shards
    (``mesh`` is taken for the TPU package's signature: each rank places
    its own shard)."""
    U_pad = _ceil_to(csr.n_users, n_dp)
    I_pad = _ceil_to(csr.n_items, n_ip)
    U_loc = U_pad // n_dp
    indptr_full = np.zeros(U_pad + 1, dtype=np.int64)
    indptr_full[:csr.n_users + 1] = csr.indptr
    indptr_full[csr.n_users + 1:] = csr.indptr[-1]
    locals_ = []
    for d in range(n_dp):
        lo_u, hi_u = d * U_loc, (d + 1) * U_loc
        lo, hi = indptr_full[lo_u], indptr_full[hi_u]
        locals_.append((
            (indptr_full[lo_u:hi_u + 1] - lo).astype(np.int32),
            csr.indices[lo:hi].astype(np.int32),
            csr.data[lo:hi].astype(np.float32),
            np.repeat(np.arange(U_loc, dtype=np.int32),
                      np.diff(indptr_full[lo_u:hi_u + 1])),
        ))
    nnz_loc = np.asarray([len(x[1]) for x in locals_], dtype=np.int32)
    NNZ = max(int(nnz_loc.max()), 1)

    def stack(k):
        return np.stack([np.pad(x[k], (0, NNZ - len(x[k])))
                         for x in locals_])

    return ShardedRatings(
        indptr=np.stack([x[0] for x in locals_]), indices=stack(1),
        data=stack(2), row_ids=stack(3), nnz=nnz_loc, total_nnz=csr.nnz,
        n_users_padded=U_pad, n_items_padded=I_pad)


@dataclass
class ShardedItemMajor:
    """The item-major sampling structure sharded by item block over ip
    (the same on every dp shard): each shard's rebased ``it_indptr``
    (n_ip, I_loc + 1) and its (user, rating) mirror ``it_users`` (global
    user ids) and ``it_vals``, (n_ip, NNZ) padded, for the twin and BPR
    item passes.  The TPU package interleaves the mirror into one
    ``it_pair`` for its gather; the draws are the same."""

    it_indptr: np.ndarray
    it_users: np.ndarray
    it_vals: np.ndarray
    nnz: np.ndarray

    def local(self, i: int, device):
        """Shard ``i``'s (it_indptr, it_users, it_vals) on ``device``."""
        n = int(self.nnz[i])
        return (_put(self.it_indptr[i], np.int32, device),
                _put(self.it_users[i, :n], np.int32, device),
                _put(self.it_vals[i, :n], np.float32, device))


def shard_ratings_item_major(csr: CSRRatings, n_ip: int,
                             mesh: Mesh | None = None) -> ShardedItemMajor:
    """Stratify the item-major view into ip item-block shards."""
    I_pad = _ceil_to(csr.n_items, n_ip)
    I_loc = I_pad // n_ip
    ip_host, it_users, it_vals = transpose_csr(csr)
    indptr_full = np.zeros(I_pad + 1, dtype=np.int64)
    indptr_full[:csr.n_items + 1] = ip_host
    indptr_full[csr.n_items + 1:] = ip_host[-1]
    locals_ = []
    for i in range(n_ip):
        lo_i, hi_i = i * I_loc, (i + 1) * I_loc
        lo, hi = indptr_full[lo_i], indptr_full[hi_i]
        locals_.append(((indptr_full[lo_i:hi_i + 1] - lo).astype(np.int32),
                        it_users[lo:hi].astype(np.int32),
                        it_vals[lo:hi].astype(np.float32)))
    nnz = np.asarray([len(x[1]) for x in locals_], dtype=np.int32)
    NNZ = max(int(nnz.max()), 1)
    return ShardedItemMajor(
        it_indptr=np.stack([x[0] for x in locals_]),
        it_users=np.stack([np.pad(x[1], (0, NNZ - len(x[1])))
                           for x in locals_]),
        it_vals=np.stack([np.pad(x[2], (0, NNZ - len(x[2])))
                          for x in locals_]),
        nnz=nnz)


def pad_model(model: MFModel, U_pad: int, I_pad: int,
              mesh: Mesh | None = None) -> MFModel:
    """The tables zero-padded to grid-divisible sizes (each rank then
    takes its blocks; ``mesh`` is the TPU package's placement argument)."""
    pad = torch.nn.functional.pad
    du, di = U_pad - model.n_users, I_pad - model.n_items
    return MFModel(P=pad(model.P, (0, 0, 0, du)), Q=pad(model.Q, (0, 0, 0, di)),
                   user_bias=pad(model.user_bias, (0, du)),
                   item_bias=pad(model.item_bias, (0, di)),
                   global_bias=model.global_bias)


def trim_model(model: MFModel, n_users: int, n_items: int) -> MFModel:
    return MFModel(P=model.P[:n_users], Q=model.Q[:n_items],
                   user_bias=model.user_bias[:n_users],
                   item_bias=model.item_bias[:n_items],
                   global_bias=model.global_bias)


def assemble_rows(local: torch.Tensor, axis: Axis, index: int,
                  n_rows: int) -> torch.Tensor:
    """The full (n_rows, W) table from each rank's block of rows along
    ``axis`` (``index`` this rank's block): the TPU package's
    ``all_gather(tiled=True)``, as a zero-filled buffer assembled."""
    if axis.size == 1:
        return local
    full = torch.zeros((n_rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    n = local.shape[0]
    full[index * n:(index + 1) * n] = local
    return axis.assemble_(full)


def elect_local(items: torch.Tensor, has: torch.Tensor, mesh: Mesh,
                I_loc: int, n_users_global: int, iteration: int,
                rotation: int = 250):
    """The first_wins election of this rank's users over its item block:
    ``(best_l, cand)``, the least rotated priority of each owned item over
    the whole grid (a local scatter-min, then a MIN over dp;
    ``INT32_MAX`` where no user sampled the item) and each local user's
    candidate priority.  The priority is of the global user id modulo the
    unpadded user count, as on one device."""
    U_loc = items.shape[0]
    user_offset = mesh.dp_index * U_loc
    item_offset = mesh.ip_index * I_loc
    owned = (items >= item_offset) & (items < item_offset + I_loc)
    loc_idx = (items - item_offset).clamp(0, I_loc - 1)
    prio = rotated_priority(n_users_global, iteration, user_offset, U_loc,
                            rotation, items.device)
    imax = torch.full_like(prio, INT32_MAX, dtype=torch.int32)
    cand = torch.where(has, prio.to(torch.int32), imax)
    best_l = torch.full((I_loc,), INT32_MAX, dtype=torch.int32,
                        device=items.device)
    best_l.scatter_reduce_(0, loc_idx, torch.where(owned, cand, imax),
                           reduce="amin")
    return mesh.dp.min_(best_l), cand


def _local_step_packed(T_u_l, T_i_l, mu, indptr_l, indices_l, data_l,
                       hp: Hyper, key, iteration: int, n_users_global: int,
                       n_factors: int, it_indptr_l=None, it_users_l=None,
                       it_vals_l=None, *, mesh: Mesh, train_items: bool,
                       collision: str, rotation: int = 250):
    """One sharded SGD iteration of this rank's blocks, plain torch (the
    TPU package's ``_local_step_packed``).  Collectives: a SUM over ip
    assembling the sampled item rows (factors and bias in one exchange);
    under first_wins a MIN over dp for the election and a SUM over ip for
    the win mask; under mean a SUM over dp of the counts and over ip of
    the denominators; under twin a SUM over dp assembling the raters'
    rows; and a SUM over dp committing the item deltas.  Returns the new
    (T_u_l, T_i_l)."""
    U_loc, W = T_u_l.shape
    I_loc = T_i_l.shape[0]
    F = n_factors
    dt = T_u_l.dtype
    lr = hp.learning_rate
    device = T_u_l.device
    user_offset = mesh.dp_index * U_loc
    item_offset = mesh.ip_index * I_loc

    items, ratings, has = sample_items(key, iteration, indptr_l, indices_l,
                                       data_l, user_offset=user_offset)
    owned = (items >= item_offset) & (items < item_offset + I_loc)
    loc_idx = (items - item_offset).clamp(0, I_loc - 1)
    row_i = mesh.ip.sum_(torch.where(owned[:, None],
                                     T_i_l[loc_idx].to(torch.float32), 0.0))

    factor, biascol, reg_u, reg_i = _reg_vectors(hp, F, W, device)
    row_u = T_u_l.to(torch.float32)
    ihat = row_i * factor + biascol
    uhat = row_u * factor + biascol
    pred = mu + torch.sum(row_u * ihat, dim=-1) + row_i[:, F]
    err = torch.where(has, ratings - pred, 0.0)
    hasf = has[:, None]
    du = lr * (err[:, None] * ihat - reg_u * row_u)
    T_u_new = torch.where(hasf, row_u + du, row_u).to(dt)
    if not train_items:
        return T_u_new, T_i_l

    if collision == "twin":
        # Each owned item samples its own (user, rating) on the stream
        # offset by the global user count; one SUM over dp assembles the
        # sampled users' pre-step rows.
        pos, has_i = sample_positions(key, iteration, it_indptr_l,
                                      user_offset=n_users_global
                                      + item_offset)
        s_uid = _take(it_users_l, pos).to(torch.int64)
        w_rat = _take(it_vals_l, pos)
        own_u = (s_uid >= user_offset) & (s_uid < user_offset + U_loc)
        loc_u = (s_uid - user_offset).clamp(0, U_loc - 1)
        w_rows = mesh.dp.sum_(torch.where(own_u[:, None], row_u[loc_u], 0.0))
        T_i32 = T_i_l.to(torch.float32)
        ihat_d = T_i32 * factor + biascol
        uhat_w = w_rows * factor + biascol
        pred_w = mu + torch.sum(w_rows * ihat_d, dim=-1) + T_i32[:, F]
        err_w = torch.where(has_i, w_rat - pred_w, 0.0)
        di = lr * (err_w[:, None] * uhat_w - reg_i * T_i32)
        return T_u_new, torch.where(has_i[:, None], T_i32 + di,
                                    T_i32).to(dt)

    di = lr * (err[:, None] * uhat - reg_i * row_i)
    if collision == "first_wins":
        best_l, cand = elect_local(items, has, mesh, I_loc, n_users_global,
                                   iteration, rotation)
        win_part = owned & has & (best_l[loc_idx] == cand)
        win = mesh.ip.sum_(win_part.to(torch.int32)) > 0
        di = torch.where(win[:, None], di, 0.0)
    elif collision == "mean":
        counts_l = torch.zeros(I_loc, dtype=torch.float32, device=device)
        counts_l.index_add_(0, loc_idx, (owned & has).to(torch.float32))
        mesh.dp.sum_(counts_l)
        denom = mesh.ip.sum_(torch.where(
            owned, torch.clamp(counts_l, min=1.0)[loc_idx], 0.0))
        di = torch.where(hasf, di / denom[:, None], 0.0)
    elif collision == "sum":
        di = torch.where(hasf, di, 0.0)
    else:
        raise ValueError(f"unknown collision policy: {collision}")

    # The owned pairs' deltas added in ascending user order (the pairs
    # that add zero are left out), then summed over dp: one rounding to
    # the table dtype.
    sel = owned & has
    dT_l = scatter_add_in_order(
        torch.zeros((I_loc, W), dtype=torch.float32, device=device),
        loc_idx[sel], di[sel])
    mesh.dp.sum_(dT_l)
    return T_u_new, (T_i_l.to(torch.float32) + dT_l).to(dt)


def _eval_local_packed(T_u_l, T_i_full, mu, n_factors: int, row_ids_l,
                       indices_l, data_l, nnz_l: int,
                       chunk_size: int = EVAL_CHUNK) -> torch.Tensor:
    """This dp shard's (Σerr², Σ|err|), float64 (2,), over its first
    ``nnz_l`` ratings against the assembled item table: K0b on CUDA
    tensors, its plain version on CPU tensors."""
    rows, cols, vals = (x[:nnz_l] for x in (row_ids_l, indices_l, data_l))
    if T_u_l.device.type == "cpu":
        return packed_error_sums_reference(
            T_u_l, T_i_full, mu, rows, cols, vals, n_factors,
            _cap_eval_chunk(chunk_size, T_u_l.shape[1]))
    from cu2rec_torch.ops.cuda_loss import packed_error_sums_cuda
    return packed_error_sums_cuda(T_u_l, T_i_full, float(mu), rows, cols,
                                  vals, n_factors)


class ShardedEngine:
    """Execution engine running the training semantics over a (dp × ip)
    grid of ranks; each rank constructs it with the same arguments.

    A drop-in for ``SingleChipEngine`` in the shared host loop
    (``train.trainer.train_with_engine``): the same eval cadence and
    plateau schedule; the eval sums are summed over the grid, so every
    rank sees the same RMSE and takes the same learning-rate decisions.
    The engine state is this rank's ``(T_u block, T_i block, global
    bias)``; ``finalize`` assembles the full model on every rank."""

    def __init__(self, train_csr: CSRRatings, test_csr: CSRRatings,
                 cfg: Config, n_devices: int | None = None, n_ip: int = 1,
                 mesh: Mesh | None = None, eval_chunk: int = EVAL_CHUNK):
        if mesh is None:
            n_total = n_devices or process_info()[1]
            mesh = make_mesh(n_total // n_ip, n_ip)
        self.mesh = mesh
        self.n_dp, self.n_ip = mesh.n_dp, mesh.n_ip
        self.device = mesh.device
        self.cfg = cfg
        self.dtype = table_dtype(cfg.dtype)
        if cfg.is_train:
            check_collision(cfg.collision_policy)
        self.eval_chunk = eval_chunk
        self.key = prng_key(cfg.seed)
        # Align the test split's dimensions to the train CSR's before
        # sharding: shard_ratings rebases local row ids against its own
        # padded user count, so a test CSR with fewer users would shard
        # against another U_loc and evaluate the wrong users.
        n_users = max(train_csr.n_users, test_csr.n_users)
        n_items = max(train_csr.n_items, test_csr.n_items)
        train_csr = normalize_csr_dims(train_csr, n_users, n_items)
        test_csr = normalize_csr_dims(test_csr, n_users, n_items)
        self.n_users, self.n_items = n_users, n_items
        self.train_sh = shard_ratings(train_csr, self.n_dp, self.n_ip)
        self.test_sh = shard_ratings(test_csr, self.n_dp, self.n_ip)
        self.U_pad = self.train_sh.n_users_padded
        self.I_pad = self.train_sh.n_items_padded
        self.U_loc = self.U_pad // self.n_dp
        self.I_loc = self.I_pad // self.n_ip
        d, i = mesh.dp_index, mesh.ip_index
        self.user_offset, self.item_offset = d * self.U_loc, i * self.I_loc
        self.train_dev = self.train_sh.local(d, self.device)
        self.test_dev = self.test_sh.local(d, self.device)
        # Built only under twin: the engine refuses twin later rather than
        # run it on no item-major shards (the item table would freeze).
        self._it_sh_placeholder = cfg.collision_policy != "twin"
        if not self._it_sh_placeholder:
            self.it_sh = shard_ratings_item_major(train_csr, self.n_ip)
            (self.train_dev.it_indptr, self.train_dev.it_users,
             self.train_dev.it_vals) = self.it_sh.local(i, self.device)

    # -- engine interface ----------------------------------------------
    def prepare(self, model: MFModel):
        """This rank's blocks of the packed, padded model, on its
        device, in the config's table dtype."""
        pm = pack(with_dtype(model.to("cpu"), self.dtype))
        pad = torch.nn.functional.pad
        T_u = pad(pm.T_u, (0, 0, 0, self.U_pad - pm.T_u.shape[0]))
        T_i = pad(pm.T_i, (0, 0, 0, self.I_pad - pm.T_i.shape[0]))
        u0, i0 = self.user_offset, self.item_offset
        return (T_u[u0:u0 + self.U_loc].contiguous().to(self.device),
                T_i[i0:i0 + self.I_loc].contiguous().to(self.device),
                pm.global_bias.to(self.device, torch.float32))

    def init_model(self, n_users: int, n_items: int, global_bias: float,
                   Q=None, item_bias=None):
        return self.prepare(init_model(
            n_users, n_items, self.cfg.n_factors, global_bias,
            seed=self.cfg.seed, dtype=self.dtype, Q=Q, item_bias=item_bias,
            device="cpu"))

    def run(self, state, hp: Hyper, start_iter: int, n_steps: int):
        if isinstance(state, MFModel):
            state = self.prepare(state)
        collision = self.cfg.collision_policy
        if collision == "twin" and self._it_sh_placeholder:
            raise ValueError(
                "collision_policy changed to 'twin' after ShardedEngine "
                "construction; rebuild the engine so the item-major "
                "shards exist")
        T_u, T_i, mu = state
        dev = self.train_dev
        train_items = bool(self.cfg.is_train)
        F = self.cfg.n_factors
        if self.device.type == "cpu":
            for k in range(int(n_steps)):
                T_u, T_i = _local_step_packed(
                    T_u, T_i, mu, dev.indptr, dev.indices, dev.data, hp,
                    self.key, int(start_iter) + k, self.n_users, F,
                    dev.it_indptr, dev.it_users, dev.it_vals,
                    mesh=self.mesh, train_items=train_items,
                    collision=collision)
            return (T_u, T_i, mu)
        from cu2rec_torch.ops.cuda_sgd import sharded_run_steps
        T_u, T_i = sharded_run_steps(
            T_u, T_i, float(mu), dev, hp, self.key, int(start_iter),
            int(n_steps), n_factors=F, mesh=self.mesh,
            n_users_global=self.n_users, train_items=train_items,
            collision=collision)
        return (T_u, T_i, mu)

    def evaluate(self, state, split: str):
        if isinstance(state, MFModel):
            state = self.prepare(state)
        T_u, T_i, mu = state
        dev = self.train_dev if split == "train" else self.test_dev
        sh = self.train_sh if split == "train" else self.test_sh
        T_i_full = assemble_rows(T_i, self.mesh.ip, self.mesh.ip_index,
                                 self.I_pad)
        sums = _eval_local_packed(T_u, T_i_full, mu, self.cfg.n_factors,
                                  dev.row_ids, dev.indices, dev.data,
                                  dev.nnz, self.eval_chunk)
        sse, sae = (float(x) for x in self.mesh.dp.sum_(sums).cpu())
        n = max(sh.total_nnz, 1)
        return math.sqrt(sse / n), sae / n

    def finalize(self, state) -> MFModel:
        """The full model on every rank (a collective: every rank calls
        it)."""
        T_u, T_i, mu = state
        T_u = assemble_rows(T_u, self.mesh.dp, self.mesh.dp_index,
                            self.U_pad)
        T_i = assemble_rows(T_i, self.mesh.ip, self.mesh.ip_index,
                            self.I_pad)
        return unpack(PackedModel(T_u=T_u[:self.n_users],
                                  T_i=T_i[:self.n_items], global_bias=mu,
                                  n_factors=self.cfg.n_factors))
