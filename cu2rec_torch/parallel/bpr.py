"""Sharded BPR training over the (dp × ip) grid of ``parallel/sharded.py``:
the user axis sharded over ``dp``, the item table row-sharded over ``ip``
(replicated at ip = 1).

BPR's three passes (``ops/bpr.py``) gather arbitrary item rows in every
pass (positives, uniform negatives, the raters' sampled positives), so an
ip-sharded item table needs four row assemblies a step, each an owned
contribution and a SUM over ``ip``: the user pass's two share their query
ids on every ip shard; the item passes' two differ per ip shard (each
shard queries its own items' negatives), so their ids are first gathered
over ``ip``, every shard answers all of them from the rows it owns, and
each shard slices its own segment back out (``assemble_items_divergent``).
Over ``dp`` the item passes assemble their sampled users' rows, and the
item-negative pass its sampled slice lengths and ids.

Every stream is a counter function of the global row id, so a sharded run
draws the ids of the one-device ``ops/bpr.py`` step bit for bit, at any
(dp, ip).  The step is plain torch on every device, as the one-device BPR
step is: it has no kernel.
"""

from __future__ import annotations

import torch

from cu2rec_torch.data.csr import CSRRatings
from cu2rec_torch.models.state import (
    MFModel, init_model, table_dtype, with_dtype,
)
from cu2rec_torch.ops.bpr import BPRDraws, _uniform_ids
from cu2rec_torch.ops.packed import PackedModel, _reg_vectors, pack, unpack
from cu2rec_torch.ops.sgd import (
    Hyper, _take, counter_uniform, fold_in, sample_items, sample_positions,
)
from cu2rec_torch.parallel.distributed import process_info
from cu2rec_torch.parallel.sharded import (
    Mesh, _ceil_to, assemble_rows, make_mesh, shard_ratings,
    shard_ratings_item_major,
)
from cu2rec_torch.utils.config import Config


def local_bpr_draws(indptr_l, indices_l, data_l, it_indptr_l, it_users_l,
                    key, iteration: int, n_users_global: int,
                    n_items_global: int, I_loc: int, *,
                    mesh: Mesh) -> BPRDraws:
    """The ids one BPR iteration samples for this rank's users and items
    (global ids, as ``ops/bpr.bpr_draws`` draws them for the same rows):
    the item-negative pass's slice lengths and positives summed over dp
    from the rank that owns each sampled user."""
    U_loc = indptr_l.shape[0] - 1
    U, I = n_users_global, n_items_global
    device = indptr_l.device
    user_offset = mesh.dp_index * U_loc
    item_offset = mesh.ip_index * I_loc
    i_pos, _r, has_u = sample_items(key, iteration, indptr_l, indices_l,
                                    data_l, user_offset=user_offset)
    j_neg = _uniform_ids(key, iteration, U_loc, I, tag=1,
                         offset=user_offset, device=device)
    # Streams keyed by the global item id: U + item_offset + local index.
    pos_y, has_y = sample_positions(key, iteration, it_indptr_l,
                                    user_offset=U + item_offset)
    u_of_y = _take(it_users_l, pos_y).to(torch.int64)
    jn_y = _uniform_ids(key, iteration, I_loc, I, tag=2,
                        offset=U + item_offset, device=device)
    v = _uniform_ids(key, iteration, I_loc, U, tag=3,
                     offset=U + I + item_offset, device=device)
    own_v = (v >= user_offset) & (v < user_offset + U_loc)
    loc_v = (v - user_offset).clamp(0, U_loc - 1)
    indptr64 = indptr_l.to(torch.int64)
    lens_l = (indptr64[1:] - indptr64[:-1]).to(torch.int32)
    len_v = mesh.dp.sum_(torch.where(own_v, lens_l[loc_v], 0))
    u01 = counter_uniform(fold_in(key, 4), iteration,
                          torch.arange(I_loc, dtype=torch.int64,
                                       device=device) + 2 * U + item_offset)
    off = torch.minimum((u01 * len_v).to(torch.int32),
                        (len_v - 1).clamp(min=0))
    pos_v = indptr64[:-1][loc_v] + off.to(torch.int64)   # where own_v
    iv = mesh.dp.sum_(torch.where(own_v, _take(indices_l, pos_v)
                                  .to(torch.int64), 0))
    return BPRDraws(i_pos, has_u, j_neg, u_of_y, has_y, jn_y, v, iv,
                    len_v > 0)


def _local_bpr_step(T_u_l, T_i_l, indptr_l, indices_l, data_l, hp: Hyper,
                    key, iteration: int, n_users_global: int,
                    n_items_global: int, n_factors: int, it_indptr_l,
                    it_users_l, *, mesh: Mesh):
    """One BPR iteration of this rank's blocks: the semantics of
    ``ops/bpr.bpr_step`` (the same streams keyed by global ids, the same
    arithmetic), the layout local blocks and row assemblies.  Returns the
    new (T_u_l, T_i_l)."""
    U_loc, W = T_u_l.shape
    I_loc = T_i_l.shape[0]
    F = n_factors
    dt = T_u_l.dtype
    lr = hp.learning_rate
    device = T_u_l.device
    user_offset = mesh.dp_index * U_loc
    item_offset = mesh.ip_index * I_loc
    s = local_bpr_draws(indptr_l, indices_l, data_l, it_indptr_l,
                        it_users_l, key, iteration, n_users_global,
                        n_items_global, I_loc, mesh=mesh)

    factor, biascol, reg_u, reg_i = _reg_vectors(hp, F, W, device)
    row_u = T_u_l.to(torch.float32)
    T_i32 = T_i_l.to(torch.float32)

    def ihat(rows):
        return rows * factor + biascol

    def assemble_items(ids):
        """(N,) global item ids, the same on every ip shard → (N, W)
        float32 rows, summed over ip from each shard's owned block."""
        owned = (ids >= item_offset) & (ids < item_offset + I_loc)
        loc = (ids - item_offset).clamp(0, I_loc - 1)
        return mesh.ip.sum_(torch.where(owned[:, None], T_i32[loc], 0.0))

    def assemble_items_divergent(ids_local):
        """(I_loc,) global item ids that differ per ip shard → (I_loc, W)
        rows: the ids gathered over ip first, every shard's owned rows
        for all of them summed, this shard's segment sliced out."""
        all_ids = assemble_rows(ids_local, mesh.ip, mesh.ip_index,
                                I_loc * mesh.n_ip)
        return assemble_items(all_ids)[item_offset:item_offset + I_loc]

    def user_rows(ids):
        """(I_loc,) global user ids → their pre-step rows, summed over dp
        from the rank that owns each."""
        own = (ids >= user_offset) & (ids < user_offset + U_loc)
        loc = (ids - user_offset).clamp(0, U_loc - 1)
        return mesh.dp.sum_(torch.where(own[:, None], row_u[loc], 0.0))

    # ---- user pass ----
    t_i = assemble_items(s.i_pos)
    t_j = assemble_items(s.j_neg)
    diff = ihat(t_i) - ihat(t_j)
    x_u = torch.sum(row_u * diff, dim=-1) + t_i[:, F] - t_j[:, F]
    e_u = torch.where(s.has_u, torch.sigmoid(-x_u), 0.0)
    du = lr * (e_u[:, None] * diff - reg_u * row_u)
    T_u_new = torch.where(s.has_u[:, None], row_u + du, row_u).to(dt)

    # ---- item-positive pass (owned block; rater rows summed over dp) ----
    w_rows = user_rows(s.u_of_y)
    uhat = ihat(w_rows)
    t_jy = assemble_items_divergent(s.jn_y)
    x_pos = (torch.sum(w_rows * factor * (T_i32 - t_jy), dim=-1)
             + T_i32[:, F] - t_jy[:, F])
    e_pos = torch.where(s.has_y, torch.sigmoid(-x_pos), 0.0)
    di_pos = lr * (e_pos[:, None] * uhat - reg_i * T_i32)

    # ---- item-negative pass ----
    v_rows = user_rows(s.v)
    t_iv = assemble_items_divergent(s.iv)
    x_neg = (torch.sum(v_rows * factor * (t_iv - T_i32), dim=-1)
             + t_iv[:, F] - T_i32[:, F])
    e_neg = torch.where(s.has_v, torch.sigmoid(-x_neg), 0.0)
    di_neg = (-lr) * e_neg[:, None] * ihat(v_rows)

    T_i_new = (T_i32 + torch.where(s.has_y[:, None], di_pos, 0.0)
               + torch.where(s.has_v[:, None], di_neg, 0.0)).to(dt)
    return T_u_new, T_i_new


class ShardedBPR:
    """(dp × ip)-sharded BPR engine: ``run(hp, key, start, n)`` and
    ``model()``; each rank of the grid constructs it with the same
    arguments."""

    def __init__(self, train_csr: CSRRatings, cfg: Config,
                 n_devices: int | None = None, mesh: Mesh | None = None,
                 model: MFModel | None = None, n_ip: int = 1):
        if mesh is None:
            n = n_devices or process_info()[1]
            mesh = make_mesh(n // n_ip, n_ip)
        self.mesh = mesh
        self.n_dp, self.n_ip = mesh.n_dp, mesh.n_ip
        self.cfg = cfg
        self.n_users = train_csr.n_users
        self.n_items = train_csr.n_items
        self.train_sh = shard_ratings(train_csr, self.n_dp, self.n_ip)
        self.U_pad = self.train_sh.n_users_padded
        self.I_pad = _ceil_to(self.n_items, self.n_ip)
        self.U_loc = self.U_pad // self.n_dp
        self.I_loc = self.I_pad // self.n_ip
        dev = mesh.device
        self.dev = self.train_sh.local(mesh.dp_index, dev)
        it_sh = shard_ratings_item_major(train_csr, self.n_ip)
        self.it_indptr, self.it_users, _vals = it_sh.local(mesh.ip_index,
                                                           dev)
        dtype = table_dtype(cfg.dtype)
        if model is None:
            model = init_model(self.n_users, self.n_items, cfg.n_factors,
                               0.0, seed=cfg.seed, dtype=dtype, device="cpu")
            model = MFModel(P=model.P, Q=model.Q,
                            user_bias=torch.zeros_like(model.user_bias),
                            item_bias=torch.zeros_like(model.item_bias),
                            global_bias=torch.zeros(()))
        pm = pack(with_dtype(model.to("cpu"), dtype))
        self.n_factors = pm.n_factors
        pad = torch.nn.functional.pad
        T_u = pad(pm.T_u, (0, 0, 0, self.U_pad - self.n_users))
        T_i = pad(pm.T_i, (0, 0, 0, self.I_pad - self.n_items))
        u0 = mesh.dp_index * self.U_loc
        i0 = mesh.ip_index * self.I_loc
        self.T_u = T_u[u0:u0 + self.U_loc].contiguous().to(dev)
        self.T_i = T_i[i0:i0 + self.I_loc].contiguous().to(dev)
        self.mu = torch.tensor(float(model.global_bias), dtype=torch.float32,
                               device=dev)

    def run(self, hp: Hyper, key, start_iter: int, n_steps: int) -> None:
        for k in range(int(n_steps)):
            self.T_u, self.T_i = _local_bpr_step(
                self.T_u, self.T_i, self.dev.indptr, self.dev.indices,
                self.dev.data, hp, key, int(start_iter) + k, self.n_users,
                self.n_items, self.n_factors, self.it_indptr, self.it_users,
                mesh=self.mesh)

    def draws(self, key, iteration: int) -> BPRDraws:
        """The ids this rank's step at ``iteration`` samples (a
        collective)."""
        return local_bpr_draws(self.dev.indptr, self.dev.indices,
                               self.dev.data, self.it_indptr, self.it_users,
                               key, iteration, self.n_users, self.n_items,
                               self.I_loc, mesh=self.mesh)

    def model(self) -> MFModel:
        """The full model on every rank (a collective)."""
        T_u = assemble_rows(self.T_u, self.mesh.dp, self.mesh.dp_index,
                            self.U_pad)
        T_i = assemble_rows(self.T_i, self.mesh.ip, self.mesh.ip_index,
                            self.I_pad)
        return unpack(PackedModel(T_u=T_u[:self.n_users],
                                  T_i=T_i[:self.n_items],
                                  global_bias=self.mu,
                                  n_factors=self.n_factors))
