#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It fails (exit code != 0, no result line)
when no CUDA device is present or the package is missing.  Phases, each
fatal on failure:

1. device: the card's name, count and power limit; float32 matmuls in full
   float32 (TF32 off);
2. build: every CUDA kernel of the port from ``cu2rec_torch/csrc``, one
   nvcc each, all started together, and each entry function's registers a
   thread, spills and shared memory from the ``-Xptxas -v`` report; then
   the host library (``csrc/ingest.cpp``, g++) that reads and writes the
   CSVs;
3. kernels: K1 (the ridge solve) against its plain PyTorch version at the
   serving path's shapes and at N on both sides of every edge between its
   kernels (``cuda_linalg.kernel_for``), with its time, the plain
   version's, the library call's, the one-block-a-system kernel's and the
   bound at the implicit fold-in wave (B=256, N=100) and at an ALS half
   sweep of ML-20M's items (B=27,000, N=101); and the shared-memory kernel
   at ALS-WR's N = 301 (a sweep's worth of systems and an item chunk's 54)
   and at N = 129, in µs a system an SM;
4. training kernels: K0a (the SGD step) for first_wins, twin (mirror and
   lean) and frozen items, three steps each at a small shape and at the
   headline shape (138,000 users, 27,000 items, F=100, 20,000,000 ratings
   built in memory from ``--seed``), the changed rows exactly and the
   tables within 1e-5 of the plain version; K0b (the eval sums) over the
   20,000,000 ratings within 1e-6 and bit-identical between two calls,
   with its item-row gather rate through L2; K2 and K3 (the gather
   probes' kernels) exactly equal to ``table[idx]``; each timed with CUDA
   events beside its bound; the step loop as the trainer runs it, with the
   host's enqueue time a step beside the profiler's kernel time a step
   (which shows whether the host sets the pace), and beside a plain copy
   of ``T_u``; then K0c (the explicit serving fold-in, every iteration in
   one launch, the request's masked arrays read as they arrive) at phase
   11 (b)'s probe shape (1,000,000 items, F=64, 512 users x 32 ratings,
   100 iterations), at phase 6's explicit wave (27,000 items, F=100, 256
   users x 8-64 ratings) and on masks with holes (256 users x 100
   columns, every eighth user none), float32 and bf16 catalogs, sampled
   directly and (float32) through rows assembled once: one
   iteration within 1e-6 of its plain version, the fold-in within 1e-5 of
   max(1, |entry|), a plain run with the iteration counter shifted by one
   rejected; timed with the stream held beside the byte bound of what it
   reads and the dependent-chain floor (every slot sampling its own row,
   kept in L2); then K5 (a model's starting tables, drawn on the card) at
   the headline model in float32 and bf16, ML-20M at F=50 and Netflix at
   F=300, each equal to ``init_model``'s CPU draw under ``torch.equal``
   (and to its plain version at ML-20M), timed with the stream held
   beside its bound, its MT19937 walk alone, torch's CUDA ``randn`` and
   the CPU draw it replaces;
5. the entry points, each with the launch counts set to 0 before it and
   read after it: ``mf`` trains a planted rank-20 model at the headline
   widths (1,000,000 train and 100,000 test ratings as CSVs, 300
   iterations) and its test RMSE must fall below the global mean's;
   ``predict`` folds in one user of 20 ratings, explicitly (K0a) and
   ``--implicit`` (K1); the two gather probes run (K2, K3);
6. serve: the ``serve`` CLI over stdio at ML-20M scale (138,000 users,
   27,000 items, F=100, 1,000,000 train ratings; random tables from
   ``--seed``): one recommend of 512 known users, 256 explicit fold-ins,
   256 implicit fold-ins and a stats request, each checked (k items, rated
   items excluded, scores against a float64 reference for a sample), with
   the kernels' launch counts read across the run (K1 and K4 by the
   implicit wave only, K0c by the explicit wave only).  Each wave is timed
   without a profiler, then sent again under ``torch.profiler``; that
   replay gives the card's busy time and its top kernels;
7. families: ALS, iALS and BPR at the headline widths.  ALS trains 5
   sweeps (F=100, regs 0.05) on ``data/synth.py::generate_planted`` draws
   (22,200,000, split 90/10, ≥ 100 items above the heavy edge of 8,192
   ratings) and its test RMSE must fall below sweep 1's and the global
   mean's; each half sweep is timed with CUDA events; K4 (the gather-Gram)
   is held against its plain version on each half sweep's largest regular
   chunk and its heavy chunk (within 1e-5 of each sum's |X|ᵀ|X| + 1e-6,
   the same bits twice) and timed beside its bound and the gather +
   ``torch.bmm`` it replaces; one sweep runs under the profiler (K4's and
   K1's shares of its device time, its bound by full Grams and by the
   triangle), and K1 is held against its plain version on the item
   sweep's largest regular chunk and on a heavy chunk, as K4 assembles
   them.  iALS trains 5 sweeps (alpha 40) on implicit planted data built
   on the card (20,000,000 draws): AUC ≥ 0.65 and recall@10 ≥ 5·10/I at
   sweep 5; K4 is held and timed on its chunks as for ALS (its data has no
   heavy chunk: K4's iALS mode is held on ALS's heavy item chunk).  BPR runs
   three steps on the card (K6) and on the CPU (the plain step; the same
   ids, tables within 1e-5), times 50 steps of the loop, K6 with the
   stream held at F = 100 and F = 50 beside its byte bound and the plain
   step on the card, then trains 2,000 iterations: AUC ≥ 0.6 and above
   iteration 1's.  Last, ``mf --algo als|ials|bpr`` on ML-100K-shaped
   planted CSVs (K1, K4 and K0b launched; K6 once an iteration in BPR,
   never in ALS or iALS, as in the 50 steps and ``train_bpr``);
8. pipeline: the preprocessing journey through the CLIs at ML-20M scale:
   ``synth --preset ml20m`` (138,000 users x 27,000 items x 20,000,000
   planted ratings), ``map_items``, ``split`` 90/10 (its fast path),
   ``mf`` F=100 for 100 iterations on the card (K0a, K0b; set-up, loop
   and export times; the native library must have been called),
   ``evaluate`` from the checkpoint (within 1e-6 of mf's final TEST line),
   from the component CSVs (within 1e-4) and with ``--ranking`` over
   10,000 users (recall@10 and NDCG@10 within one user's share of a float64
   NumPy top-10 from the checkpoint), ``convert_to_np`` of the
   exported Q (within 5e-7 and the float32 rounding of the checkpoint's),
   and the native ratings reader against its plain version on the test
   split (the same arrays, both times printed);
9. variants: the runs of a mean/sum step on the card (its sampling,
   counting sort and ordering, ``collision_runs_cuda``) bit for bit against
   ``torch.sort(stable=True)`` and ``torch.bincount`` on uniform and on
   power-law items, the check rejecting a planted swap of two users in a
   run and a planted dropped pair; K0a on bf16 tables (first_wins, twin)
   and under the mean and sum collision policies (float32 and bf16) at the
   headline shape, two steps each against the plain version (float32
   within 1e-5, bf16 within one bf16 ulp of each entry's operand scale,
   two on the item side of mean and sum, whose adds each round; mean and
   sum the same bits in two calls), each timed with the stream held (the
   card's time) and as the trainer's loop runs it, beside its bound, and
   each mean/sum step under the profiler (its kernels, and the item side:
   the kernel time outside the user kernel, beside ``index_add_`` of the
   step's pairs), on uniform items and, for float32 mean and bf16 sum, on
   power-law items; K0b on bf16 tables over
   the 20,000,000 ratings (rtol 1e-6, the same bits twice).  Then, on
   phase 5's CSVs (so it runs right after phase 5): ``mf --dtype
   bfloat16`` and ``mf --collision mean`` (test RMSE below iteration 1's
   and the global mean's, printed beside the float32 run's), the trainer
   for the other variants, ``predict`` with a bf16 config, ``mf --algo als``
   in float32 and bf16 on ML-100K-shaped CSVs, ``foldin_ranking_eval``
   explicit and implicit (recall@10 above a random 10/I), and
   ``ServeClient`` against the daemon over a unix socket: 10,000
   single-user recommends, each the engine's own top-10, and a fold-in;
10. sharded training (``cu2rec_torch/parallel``): (a) a world of one
   rank under NCCL at the headline shape: K0a's sharded mode
   (``csrc/sgd_sharded.cu``, the kernels split at the collectives) for
   first_wins, twin, mean and sum, float32 and bf16, two steps each
   against the plain local step (float32 within 1e-5, bf16 within one
   ulp of the operands' scale: the step rounds once), the item side
   written directly (dp = 1, no apply launched) against the same step's
   dT applied, bit for bit, on uniform and power-law items, timed with
   the stream held beside the fused K0a step in the same call and beside
   its bound (the one-device step's bytes, which it moves at dp = 1;
   the bytes at dp > 1 and those of the full-width dT design it
   replaced beside them); then
   ``ShardedEngine`` three steps of each policy, float32 against the
   one-device engine (tables within 1e-6 / 1e-5 of max(1, |entry|), the
   eval within rtol 1e-5) and bf16 near float32's RMSE; (b) 2 ranks
   (dp=2) and 4 ranks (dp=2, ip=2) under gloo sharing the card, at ML-1M's
   depth (6,040 x 3,706, 1,000,209 planted ratings) and F=100, each rank's
   kernel step against its plain step over the grid's collectives and
   rank 0's model against the one-device engine, each rank's memory
   printed (gloo stages every CUDA all_reduce through the host: a check,
   not a timing); (c) ALS and iALS two sweeps and BPR 50 steps at dp=2
   against one device, K1 launched on every rank, BPR's ids bit-equal;
   (d) ``mf --devices 1 --device cuda`` trains and ``mf --devices 2
   --device cuda`` on a one-card host raises the fewer-cards error;
11. sharded serving (``ShardedServingEngine``, ``parallel/serving.py``):
   (a) phase 6's catalog and waves through the daemon over 2 and 4 item
   shards on the card, every recommend within rtol 1e-5 and every
   implicit fold-in within 1e-3 of phase 6's responses, the explicit
   wave's rows (in one batch) within 1e-6 of one device's and the
   implicit rows within K1's tolerance, K1 and K4 launched by the implicit
   wave only and K0c by the explicit wave only (one launch a fold-in batch,
   after one assembly of the rows over the shards); each wave's latency
   and requests/s beside phase 6's; (b) the TPU package's serving probe
   shape (1,000,000 items, F=64, batch 512, k=10, fold-ins of 32 ratings
   and 100 iterations) over 1, 2 and 4 shards: recommend users/s, a
   fold-in batch's time (one K0c launch each), the host time of each of
   its stages (pack, copy in, init, assemble, launch, copy out) and its
   device time, and 32 users' top-10 against a float64 reference; (c)
   two gloo ranks sharing
   the card, a shard each: the ranks bit-equal, the rank-mode engine
   against the one-process shards, ``sharded_ranking_eval`` equal to
   ``ranking_eval``, one K0c launch a fold-in on each rank; (d) ``serve
   --devices 2 --device cuda`` on a one-card host raises the fewer-cards
   error.

Phases 5-11 also count, each from 0 just before it, K5's launches and
``init_model``'s ``model.init.card_draws`` and ``.cpu_draws`` (the
program's recorder on): one launch a card draw, and every model of the
training paths drawn on the card.

It prints the kernels' JSON line, then the nvidia-smi name/power line, then
``{"ok": true, "device": {...}}`` as the last line.

    python3 chip_smoke.py --nccl

runs, on a host of four cards, only phases 1-2, the sharded step's time
at the headline shape on 4 x 1 and 2 x 2 grids beside one card's fused
step, with the time of the dT SUM over dp, and phase 10 (b)-(c) under
NCCL, one rank a card (the engine on 4 x 1, 2 x 2 and 1 x 4 grids, the
families on 2 x 2), then ``mf --devices 4
--device cuda`` against ``--devices 1``; then phase 6's waves through
``serve --devices 1`` and ``serve`` with no ``--devices`` (an item shard
on every card: the stats must say four; their times, every response of
the four cards against the one card's) and phase 11 (c) on four NCCL
ranks, a card each.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Ridge-solve tolerance: float32 Cholesky of condition number < ~10.
RTOL, ATOL = 1e-3, 1e-4
# N on both sides of each edge between K1's kernels (31|32, 63|64,
# 103|104, 127|128, 338|339), and the serving path's shapes.
SHAPES = [(7, 9), (64, 31), (64, 32), (1000, 51), (64, 63), (64, 64),
          (256, 100), (64, 101), (64, 103), (64, 104), (64, 127), (64, 128),
          (33, 301), (8, 338), (8, 339), (8, 400)]
MAIN_SHAPE = (256, 100)          # the implicit fold-in batch at F=100
ALS_SHAPE = (27_000, 101)        # an ALS item half sweep of ML-20M at F=100
# K1's shared-memory kernel timed alone: ALS-WR at F = 300 (N = 301) on a
# sweep's worth of systems and on an item chunk's 54 (under one wave of
# the card's SMs), and N = 129 (ALS at F = 128).
SHARED_SHAPES = ((4096, 301), (54, 301), (4096, 129))
U, I, F = 138_000, 27_000, 100   # bench.py's ML-20M-scale headline model
N_RATINGS = 1_000_000            # the serve phase's train ratings
N_HEADLINE = 20_000_000          # bench.py's rating count: K0a and K0b
# The training phase's planted model and its CSVs (read with numpy's
# genfromtxt, which is why they hold 1.1 M of the 20 M ratings).
RANK, TRAIN_RATINGS, TEST_RATINGS = 20, 1_000_000, 100_000
TRAIN_ITERATIONS = 300
# The training phase's export with the per-value Python CSV writer, before
# the native writer (NVIDIA H100 80GB HBM3, 700 W).
PYTHON_EXPORT_S = 17.77
# K0a's cases: (collision, lean item-major layout, train items).
STEP_CASES = (("first_wins", False, True), ("twin", False, True),
              ("twin", True, True), ("first_wins", False, False))
# K0a may contract float32 multiply-adds into FMAs (its plain version does
# not): a step's tables agree within a few float32 roundings.  K0b and its
# plain version both sum in float64.
STEP_ATOL, EVAL_RTOL = 1e-5, 1e-6
# A CUDA profiler session at times records no device event at all (once in
# a smoke run, the twin step loop's session came back empty): a session
# that does is run again, up to this many times.
PROFILE_TRIES = 3


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


# -- phase 1: device ---------------------------------------------------------

def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    require(not torch.backends.cuda.matmul.allow_tf32,
            "TF32 matmul is on: float32 products would not be float32")
    log(f"[device] {name} x{count} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    return name, count, smi


# -- phase 2: build ----------------------------------------------------------

def _kernel_name(mangled: str) -> str:
    """``kernel<template args>`` from a mangled entry name: integers and
    booleans as numbers, a row layout's element type as float32 or
    bfloat16 (``sgd_user_kernel<128,float32,0>``)."""
    k = re.search(r"([a-z_]+_kernel)(I.*)?", mangled)
    if not k:
        return mangled
    args = (k[2] or "").split("Ev")[0]
    names = {"13__nv_bfloat16": "bfloat16", "f": "float32"}
    found = [t[1] or names[t[0]] for t in re.finditer(
        r"L[ib](\d+)E|13__nv_bfloat16|(?<=E)f(?=E|L)", args)]
    return k[1] + (f"<{','.join(found)}>" if found else "")


def _ptxas_report(text: str):
    """[(function, registers, spilled bytes, shared bytes)] for each entry
    function of an ``-Xptxas -v`` build log, the name shortened from its
    mangling to ``kernel<template args>``."""
    report, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m[1])
            spill = 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            report.append((name, int(m[1]), spill,
                           int(smem[1]) if smem else 0))
            name = None
    return report


def phase_build():
    """Builds every kernel; returns {library: {function: registers}}."""
    from cu2rec_torch.csrc.build import KERNELS, build, build_log
    from cu2rec_torch.data import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # The host library (g++) builds while nvcc builds the kernels.
        host = pool.submit(native.available)
        libs = build(KERNELS)
        log(f"[build] {len(libs)} kernel(s) in "
            f"{time.perf_counter() - t0:.1f} s")
        require(host.result(), "the native host library is switched off "
                "(CU2REC_NO_NATIVE) or has no host compiler")
    log(f"[build] host library ingest (g++, beside nvcc) done at "
        f"{time.perf_counter() - t0:.1f} s")
    registers = {}
    for name in KERNELS:
        report = _ptxas_report(build_log(name))
        require(report, f"no -Xptxas -v report in the build log of {name}")
        registers[name] = {fn: regs for fn, regs, _, _ in report}
        for fn, regs, spill, smem in report:
            log(f"[build] {name}: {fn}: {regs} registers a thread, {spill} "
                f"bytes spilled, {smem} bytes of static shared memory")
            # K4 keeps each thread's 64 sums in registers: a spill would
            # put them in local memory.
            require(name != "gather_gram" or spill == 0,
                    f"{name}: {fn} spills {spill} bytes")
    return registers


# -- phase 3: kernels --------------------------------------------------------

def _tpu_kernel_site(rel: str, needle: str) -> str:
    """``<dir>/<rel>:<line>`` of the TPU code a kernel of the port replaces
    (or takes its semantics from), found in the checkout outside the port's
    own package (the TPU package is read, never imported)."""
    for path in sorted(HERE.glob(f"*/{rel}")):
        if path.relative_to(HERE).parts[0] == "cu2rec_torch":
            continue
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(needle):
                return f"{path.relative_to(HERE)}:{n}"
    return f"{rel} ({needle})"


def _spd(torch, B, N, seed, dev):
    """B random SPD systems G = A·Aᵀ/N + I/2 (condition number below ~10)
    and right-hand sides, made on the card from the seed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn((B, N, N), generator=gen, device=dev)
    G = A @ A.mT / N + 0.5 * torch.eye(N, device=dev)
    rhs = torch.randn((B, N), generator=gen, device=dev)
    return (G + G.mT) / 2, rhs


def _time_ridge(torch, cl, sets, reps):
    """K1 through its wrapper, its plain version, the library solve and the
    one-block-a-system kernel (called past the wrapper, so uncounted) on
    the same sets: a dict of the max abs error against the plain version,
    the times and the bound."""
    from cu2rec_torch.experiments.common import time_ms

    def library(G, rhs):  # cholesky_ex: no host sync on the info check
        L = torch.linalg.cholesky_ex(G).L
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]

    def one_block(G, rhs):
        return cl._launch(G, rhs, "shared")

    got = cl.ridge_solve_batched_cuda(*sets[0])
    want = cl.ridge_solve_reference(*sets[0])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
            f"ridge_cholesky disagrees with its plain version: {err}")
    for fn in (library, one_block):
        other = float((fn(*sets[0]) - got).abs().max())
        require(other < 1e-3, f"{fn.__name__} disagrees with K1: {other}")
    B, N = sets[0][1].shape
    # A Cholesky solve of a symmetric G needs only its lower triangle.
    n_bytes = 4 * (B * N * (N + 1) // 2 + 2 * B * N)
    n_ops = B * (N ** 3 / 3 + 2 * N ** 2)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    # The kernels' time on the card alone: a call of the wrapper costs the
    # host about as much as K1 takes on the card at the serving shape.  The
    # library call, whose host side takes longer than its kernels, is timed
    # as its caller sees it; so is K1's wrapper, for ``call_ms``.
    t = {"ms": time_ms(cl.ridge_solve_batched_cuda, sets, reps=reps,
                       hold=True),
         "call_ms": time_ms(cl.ridge_solve_batched_cuda, sets, reps=reps),
         "one_block_ms": time_ms(one_block, sets, reps=reps, hold=True),
         "library_ms": time_ms(library, sets, reps=max(1, reps // 2)),
         "plain_ms": time_ms(cl.ridge_solve_reference, sets, reps=1,
                             warm=1)}
    log(f"[kernel] ridge_cholesky B={B} N={N} ({cl.kernel_for(N)}): "
        f"{t['ms']:.4f} ms kernel ({t['call_ms']:.4f} ms a call of the "
        f"wrapper, host included), {t['one_block_ms']:.4f} ms one block a "
        f"system, {t['plain_ms']:.3f} ms plain, {t['library_ms']:.4f} ms "
        f"library (cholesky_ex + cholesky_solve), bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e6:.1f} MFLOP), "
        f"max_abs_err {err:.3e}")
    return dict(t, max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                shape={"B": B, "N": N})


def phase_kernels(torch, dev):
    from cu2rec_torch.ops import cuda_linalg as cl

    for B, N in SHAPES:
        G, rhs = _spd(torch, B, N, seed=N, dev=dev)
        got = cl.ridge_solve_batched_cuda(G, rhs)
        torch.cuda.synchronize()
        want = cl.ridge_solve_reference(G, rhs)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        log(f"[kernel] ridge_cholesky B={B} N={N} ({cl.kernel_for(N)}): "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ok={ok}")
        require(ok and torch.isfinite(got).all(),
                f"ridge_cholesky disagrees with its plain version at "
                f"B={B} N={N}: max abs err {err}")

    B, N = MAIN_SHAPE
    entry = {"name": "ridge_cholesky", "route": "cuda",
             "source": "cu2rec_torch/csrc/ridge_cholesky.cu",
             "replaces": _tpu_kernel_site("ops/pallas_linalg.py",
                                          "def _ridge_kernel"),
             "launches": None}
    entry.update(_time_ridge(torch, cl, [
        _spd(torch, B, N, seed=1000 + s, dev=dev) for s in range(6)],
        reps=60))
    # The ALS shape: one set of 1.1 GB, so each call finds the cache cold.
    B, N = ALS_SHAPE
    entry["als"] = _time_ridge(torch, cl, [_spd(torch, B, N, seed=2000,
                                                dev=dev)], reps=10)
    entry["shared"] = [_time_shared(torch, cl, B, N, dev)
                       for B, N in SHARED_SHAPES]
    torch.cuda.empty_cache()
    return [entry]


def _time_shared(torch, cl, B, N, dev):
    """K1's shared-memory kernel (one block a system) at B systems of N,
    checked against its plain version, timed with the stream held: the
    kernel time, and µs a system an SM, the time × SMs / B over full waves
    and the time itself for a launch under one wave; and the plain
    version's time."""
    from cu2rec_torch.experiments.common import time_ms

    require(cl.kernel_for(N) == "shared", f"N={N} is not the shared kernel's")
    G, rhs = _spd(torch, B, N, seed=3000 + N, dev=dev)
    got = cl.ridge_solve_batched_cuda(G, rhs)
    want = cl.ridge_solve_reference(G, rhs)
    err = float((got - want).abs().max())
    require(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
            f"the shared kernel disagrees with its plain version at B={B} "
            f"N={N}: {err}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ms = time_ms(cl.ridge_solve_batched_cuda, [(G, rhs)], reps=20, hold=True)
    plain_ms = time_ms(cl.ridge_solve_reference, [(G, rhs)], reps=1, warm=1)
    us = ms * 1e3 * (sms / B if B >= sms else 1)
    n_bytes = 4 * (B * N * (N + 1) // 2 + 2 * B * N)
    n_ops = B * (N ** 3 / 3 + 2 * N ** 2)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    log(f"[kernel] ridge_cholesky shared B={B} N={N}: {ms:.4f} ms kernel, "
        f"{us:.2f} us a system an SM ({sms} SMs), {plain_ms:.3f} ms plain, "
        f"bound {bound_ms:.4f} ms ({bound_by}), max_abs_err {err:.3e}")
    del G, rhs, got, want
    return {"B": B, "N": N, "ms": ms, "us_a_system_an_sm": us,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


# -- phase 4: the training path's kernels (K0a, K0b) and the probes' (K2, K3)

def _hp():
    """The step's hyperparameters in the kernel checks and timings."""
    from cu2rec_torch.ops.sgd import Hyper

    return Hyper(0.05, 0.02, 0.02, 0.02, 0.02)


def _bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 peak."""
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_FLOP_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def _entry(name, site, err, ms, plain_ms, n_bytes, n_ops, library_ms,
           shape, semantics=None, source=None):
    """One kernel's record of the ``{"kernels": [...]}`` line.  A kernel
    with no TPU kernel behind it has ``replaces`` null and names the TPU
    code whose semantics it takes in ``semantics``."""
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    e = {"name": name, "route": "cuda",
         "source": f"cu2rec_torch/csrc/{source or name}.cu",
         "replaces": None if semantics else site, "launches": None,
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by,
         "library_ms": library_ms, "shape": shape}
    if semantics:
        e["semantics"] = f"{site} {semantics}"
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[kernel] {name} {shape}: {ms:.4f} ms kernel, {plain_ms:.3f} ms "
        f"plain, library {lib}, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} MFLOP), max_abs_err "
        f"{err:.3e}")
    return e


def _packed_tables(torch, n_users, n_items, n_factors, seed, dev):
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops.packed import pack

    rng = np.random.default_rng(seed)
    return pack(model_from_numpy({
        "p": rng.normal(0, 0.1, (n_users, n_factors)),
        "q": rng.normal(0, 0.1, (n_items, n_factors)),
        "user_bias": rng.normal(0, 0.1, n_users),
        "item_bias": rng.normal(0, 0.1, n_items),
        "global_bias": [3.5]}, dev))


def _headline_csr(seed: int, item_power: float | None = None):
    """bench.py's headline ratings shape, 20,000,000 ratings over U users
    and I items, built in memory from the seed (no CSV).  Items are drawn
    uniformly, or with ``item_power`` from the power law of
    ``data/synth.py::generate_planted`` (item 0 the most popular)."""
    from cu2rec_torch.data.csr import CSRRatings

    rng = np.random.default_rng(seed)
    counts = np.bincount(rng.integers(0, U, N_HEADLINE), minlength=U)
    indptr = np.zeros(U + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    if item_power is None:
        items = rng.integers(0, I, N_HEADLINE, dtype=np.int32)
    else:
        items = np.minimum((I * rng.power(item_power, N_HEADLINE)).astype(
            np.int32), I - 1)
    return CSRRatings(
        indptr=indptr,
        indices=items,
        data=(rng.integers(1, 11, N_HEADLINE) / 2.0).astype(np.float32),
        n_users=U, n_items=I)


def _small_csr(seed: int):
    """3,000 users x 800 items, 30,000 ratings; users 0-9 and items 0-4
    have none (their rows must come out of a step unchanged)."""
    from cu2rec_torch.data.csr import csr_from_arrays

    rng = np.random.default_rng(seed)
    n = 30_000
    return csr_from_arrays(rng.integers(10, 3000, n), rng.integers(5, 800, n),
                           (rng.integers(1, 11, n) / 2.0).astype(np.float32),
                           3000, 800)


def _step_bytes(csr, n_factors, collision, lean, train_items, elem=4):
    """Bytes one step must move: each table read and written once, the
    user indptr, and one sampled (item, rating) per user with ratings;
    under twin, the item indptr and one sampled (user, rating) per item
    with ratings (through the permutation when lean).  Under every policy
    an item row is read and written once: mean and sum add an item's
    deltas to it in order, and the pre-step user rows the deltas read are
    the user table's, read once already.  ``elem`` is the tables' bytes an
    entry.  The election buffer and the collision sort's arrays are
    scratch, not input or output."""
    from cu2rec_torch.ops.packed import packed_width

    W = packed_width(n_factors)
    u_has = int(np.count_nonzero(np.diff(csr.indptr)))
    n = 2 * csr.n_users * W * elem + 4 * (csr.n_users + 1) + 8 * u_has
    if train_items:
        n += 2 * csr.n_items * W * elem
    if train_items and collision == "twin":
        i_has = int(np.count_nonzero(np.bincount(csr.indices,
                                                 minlength=csr.n_items)))
        n += 4 * (csr.n_items + 1) + (12 if lean else 8) * i_has
    return n


def _check_steps(torch, csr, n_factors, seed, dev, label):
    """Three steps of each case, kernel against plain version from the same
    tables: the same rows change and the tables agree within STEP_ATOL.
    Returns the largest absolute difference."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.ops.packed import packed_step, packed_step_reference
    from cu2rec_torch.ops.sgd import prng_key

    worst = 0.0
    for collision, lean, train_items in STEP_CASES:
        dr = to_device(csr, dev, item_major=collision == "twin", lean=lean)
        pm = _packed_tables(torch, csr.n_users, csr.n_items, n_factors,
                            seed, dev)
        for it in range(3):
            kw = dict(train_items=train_items, collision=collision)
            got = packed_step(pm, dr, _hp(), prng_key(seed), it, **kw)
            want = packed_step_reference(pm, dr, _hp(), prng_key(seed), it,
                                         **kw)
            torch.cuda.synchronize()
            for side in ("T_u", "T_i"):
                g, w, p = (getattr(x, side) for x in (got, want, pm))
                require(torch.equal((g != p).any(1), (w != p).any(1)),
                        f"sgd_step {label} {collision} lean={lean} step "
                        f"{it}: the changed rows of {side} differ")
                err = float((g - w).abs().max())
                worst = max(worst, err)
                require(err <= STEP_ATOL,
                        f"sgd_step {label} {collision} lean={lean} step "
                        f"{it}: {side} differs by {err}")
            pm = got
        log(f"[kernel] sgd_step {label} {collision} lean={lean} "
            f"train_items={train_items}: 3 steps, the same rows changed, "
            f"max_abs_err so far {worst:.3e}")
        del dr
    return worst


def _time_steps(torch, pm, dr, collision, n_steps: int = 50):
    """(event ms, host ms, host enqueue ms), each a step, over a run of
    ``packed_run_steps`` as the trainer runs it, after a warm-up run: CUDA
    events around the run, the host clock to its synchronize, and the host
    clock from ``start.record()`` to the end of its launch loop.  Where the
    enqueue time reaches the card's kernel time a step, the host sets the
    loop's pace."""
    from cu2rec_torch.ops.packed import packed_run_steps
    from cu2rec_torch.ops.sgd import prng_key

    packed_run_steps(pm, dr, _hp(), prng_key(1), 0, 3, True, collision)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    t_rec = time.perf_counter()
    packed_run_steps(pm, dr, _hp(), prng_key(1), 3, n_steps, True, collision)
    enqueue = (time.perf_counter() - t_rec) * 1e3 / n_steps
    end.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / n_steps
    return start.elapsed_time(end) / n_steps, host, enqueue


def _has_device_time(torch, prof) -> bool:
    """Whether a stopped session recorded a device event, read from its raw
    trace: the parsed event list is built only when asked for, and building
    it while the daemon serves would hold the interpreter."""
    return any(e.device_type() == torch.autograd.DeviceType.CUDA
               for e in prof.profiler.kineto_results.events())


def _new_profile(torch):
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])


def _profiled(torch, run, profile):
    """(profile, host seconds) of ``run()`` under a session from
    ``profile()``, run again while the session records no device event, at
    most PROFILE_TRIES times; ``run`` ends in a synchronize."""
    for _ in range(PROFILE_TRIES):
        prof = profile()
        prof.start()
        t0 = time.perf_counter()
        run()
        host_s = time.perf_counter() - t0
        prof.stop()
        if _has_device_time(torch, prof):
            return prof, host_s
    raise SmokeFailure(f"{PROFILE_TRIES} profiler sessions in a row "
                       "recorded no device time")


def _profile_steps(torch, pm, dr, collision, n_steps: int = 20):
    """The step loop under torch.profiler: (device busy ms per step, host
    ms per step, top kernels, busy ms per step outside the user kernel: the
    item side)."""
    from cu2rec_torch.ops.packed import packed_run_steps
    from cu2rec_torch.ops.sgd import prng_key

    def run():
        packed_run_steps(pm, dr, _hp(), prng_key(2), 0, n_steps, True,
                         collision)
        torch.cuda.synchronize()

    prof, host_s = _profiled(torch, run, lambda: _new_profile(torch))
    busy_s, top = _device_breakdown(torch, prof, top=8)
    side_s, _ = _device_breakdown(torch, prof, outside="sgd_user_kernel")
    return (busy_s * 1e3 / n_steps, host_s * 1e3 / n_steps, top,
            side_s * 1e3 / n_steps)


def phase_train_kernels(torch, dev, seed: int):
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.ops import cuda_gather, cuda_loss
    from cu2rec_torch.ops.loss import packed_error_sums_reference
    from cu2rec_torch.ops.packed import packed_step_reference
    from cu2rec_torch.ops.sgd import prng_key

    entries = []
    # K0a: the SGD step, at a small shape and at the headline shape.
    err = _check_steps(torch, _small_csr(seed), 16, seed, dev, "small F=16")
    t0 = time.perf_counter()
    csr = _headline_csr(seed)
    log(f"[kernel] headline ratings: {U} users x {I} items, "
        f"{csr.nnz} ratings ({time.perf_counter() - t0:.1f} s)")
    err = max(err, _check_steps(torch, csr, F, seed, dev, f"headline F={F}"))
    pm = _packed_tables(torch, U, I, F, seed, dev)
    times = {}
    # The profiler's first session pays for its own start: run one short
    # session before the two that are read.
    _profile_steps(torch, pm, to_device(csr, dev), "first_wins", n_steps=2)
    for collision in ("first_wins", "twin"):
        dr = to_device(csr, dev, item_major=collision == "twin")
        ms, host_ms, enqueue_ms = _time_steps(torch, pm, dr, collision)
        busy_ms, prof_host_ms, top, _side = _profile_steps(torch, pm, dr,
                                                           collision)
        user_ms = sum(t / n for k, t, n in top if "sgd_user_kernel" in k)
        plain_ms = time_ms(lambda: packed_step_reference(
            pm, dr, _hp(), prng_key(1), 7, collision=collision), [()],
            reps=3)
        times[collision] = (ms, plain_ms, _step_bytes(csr, F, collision,
                                                      False, True),
                            enqueue_ms, busy_ms, user_ms)
        log(f"[steps] {collision} at U={U} I={I} F={F}: {ms:.4f} ms a step "
            f"(CUDA events over 50 steps as the trainer runs them), "
            f"{U / ms * 1e3:.4g} user updates/s; the host enqueueing a step "
            f"in {enqueue_ms:.4f} ms, {enqueue_ms / busy_ms:.1%} of the "
            f"card's kernel time a step "
            f"({'host' if enqueue_ms >= busy_ms else 'device'}-paced), "
            f"{host_ms:.4f} ms a step by the host clock; under the "
            f"profiler {busy_ms:.4f} ms of kernel time a step, "
            f"{busy_ms / ms:.1%} of the event time a step, user kernel "
            f"span {user_ms:.4f} ms (the span of an early-launched kernel "
            f"includes its wait), in {prof_host_ms:.4f} ms of host time a "
            f"step; top: "
            + "; ".join(f"{k[:50]} {t:.3f} ms x{n}" for k, t, n in top[:3]))
        del dr
    # A plain copy of T_u, its read and its write: the least the user
    # kernel's own traffic takes on this card.
    T_copy = torch.empty_like(pm.T_u)
    copy_ms = time_ms(lambda: T_copy.copy_(pm.T_u), [()], reps=50)
    log(f"[steps] a plain copy of T_u ({pm.T_u.numel() * 4 / 1e6:.1f} MB "
        f"each way): {copy_ms:.4f} ms, "
        f"{2 * pm.T_u.numel() * 4 / copy_ms / 1e9:.3f} TB/s")
    del T_copy
    ms, plain_ms, n_bytes, enqueue_ms, busy_ms, user_ms = times["first_wins"]
    n_ops = 5 * 128 * (U + I)
    entry = _entry("sgd_step", _tpu_kernel_site("ops/packed.py",
                                                "def packed_step("),
                   err, ms, plain_ms, n_bytes, n_ops, None,
                   {"U": U, "I": I, "F": F, "W": 128, "nnz": N_HEADLINE,
                    "collision": "first_wins"}, semantics="packed_step")
    entry.update(kernel_ms=busy_ms, enqueue_ms=enqueue_ms,
                 user_kernel_ms=user_ms, tu_copy_ms=copy_ms)
    entry["twin_ms"], entry["twin_plain_ms"] = times["twin"][:2]
    entry["twin_kernel_ms"] = times["twin"][4]
    entry["twin_bound_ms"] = _bound(times["twin"][2], n_ops)[0]
    entries.append(entry)

    # K0b: the eval sums over all 20,000,000 ratings.
    dr = to_device(csr, dev)
    args = (pm.T_u, pm.T_i, 3.5, dr.row_ids, dr.indices, dr.data, F)
    got = cuda_loss.packed_error_sums_cuda(*args)
    again = cuda_loss.packed_error_sums_cuda(*args)
    want = packed_error_sums_reference(pm.T_u, pm.T_i, pm.global_bias,
                                       *args[3:])
    torch.cuda.synchronize()
    require(torch.equal(got, again), "eval_error is not deterministic")
    rel = float(((got - want).abs() / want.abs()).max())
    require(rel <= EVAL_RTOL, f"eval_error differs from its plain version "
            f"by {rel:.3e} (relative)")
    log(f"[kernel] eval_error at {N_HEADLINE} ratings: sums {got.tolist()}, "
        f"relative difference from the plain version {rel:.3e}")
    ms = time_ms(cuda_loss.packed_error_sums_cuda, [args], reps=20)
    plain_ms = time_ms(packed_error_sums_reference,
                        [(pm.T_u, pm.T_i, pm.global_bias) + args[3:]],
                        reps=3)
    n_bytes = 12 * N_HEADLINE + 4 * (F + 1) * (U + I) + 16
    entry = _entry(
        "eval_error", _tpu_kernel_site("ops/loss.py",
                                       "def _eval_packed_jit"),
        float((got - want).abs().max()), ms, plain_ms, n_bytes,
        (2 * (F + 1) + 4) * N_HEADLINE, None,
        {"U": U, "I": I, "F": F, "W": 128, "nnz": N_HEADLINE},
        semantics="_eval_packed_jit")
    # Each rating gathers its item row's F + 1 used columns through L2: the
    # practical floor of a per-rating eval, above the HBM byte bound.
    entry["l2_gather_tb_s"] = N_HEADLINE * 4 * (F + 1) / (ms * 1e-3) / 1e12
    log(f"[kernel] eval_error: item-row gather through L2 "
        f"{N_HEADLINE * 4 * (F + 1) / 1e9:.2f} GB at "
        f"{entry['l2_gather_tb_s']:.3f} TB/s; HBM bound share "
        f"{entry['bound_ms'] / ms:.1%}")
    entries.append(entry)
    del dr, csr

    # K2 and K3 at the probes' shapes, exact against table[idx].
    # K2 reads each gathered row and writes it; K3 reads the table once
    # and writes each gathered row.
    gen = torch.Generator().manual_seed(seed)
    for name, fn, plain, rows, draws, site, n_bytes in (
            ("row_gather", cuda_gather.row_gather,
             cuda_gather.row_gather_reference, 131_072, 131_072,
             ("gather_roofline.py", "def _pallas_row_gather"),
             4 * 131_072 + 2 * 131_072 * 128 * 4),
            ("smem_gather", cuda_gather.smem_gather,
             cuda_gather.smem_gather_reference, 448, 1 << 20,
             ("vmem_gather_probe.py", "def vmem_gather"),
             4 * (1 << 20) + (1 << 20) * 128 * 4 + 448 * 128 * 4)):
        table = torch.randn((rows, 128), generator=gen).to(dev)
        sets = [(table, torch.randint(0, rows, (draws,), generator=gen)
                 .to(dev, torch.int32)) for _ in range(4)]
        for t, idx in sets:
            require(torch.equal(fn(t, idx), t[idx.long()]),
                    f"{name} differs from table[idx]")
        ms = time_ms(fn, sets, reps=40)
        plain_ms = time_ms(plain, sets, reps=40)
        library_ms = time_ms(lambda t, i: torch.index_select(t, 0, i),
                             sets, reps=40)
        entries.append(_entry(name, _tpu_kernel_site(*site), 0.0, ms,
                              plain_ms, n_bytes, 0, library_ms,
                              {"I": rows, "W": 128, "M": draws}))
        del table, sets
    torch.cuda.empty_cache()
    return entries


# K0c, the explicit serving fold-in, at phase 11 (b)'s probe shape, at
# phase 6's explicit wave and on a request with holes in its mask: (label,
# items, F, batch, widest rating list, fewest ratings a user, iterations,
# holes).  After one iteration the kernel's rows are within FOLD_ONE_ATOL
# of its plain version's (a few float32 roundings); after the whole fold-in
# within FOLD_RTOL of max(1, |entry|), K0a's step tolerance: each iteration
# may contract a multiply-add the plain version rounds twice.
FOLD_CASES = (("probe", 1_000_000, 64, 512, 32, 32, 100, False),
              ("phase 6", I, F, 256, 64, 8, 100, False),
              ("holey", I, F, 256, 100, 0, 100, True))
FOLD_ONE_ATOL, FOLD_RTOL = 1e-6, 1e-5
# Input sets K0c's timing cycles through: 8 batches' sampled rows (8.4 MB
# each at the probe shape) exceed the 50 MB L2, as a wave finds them cold.
FOLD_SETS = 8


def _fold_inputs(torch, dev, seed: int, n_items: int, n_f: int, B: int,
                 D: int, lo: int, dtype, n_sets: int, holey: bool = False):
    """A random catalog of ``n_items`` packed rows in ``dtype`` and
    ``n_sets`` batches (T_u, table, index, vals, mask) over it, made on the
    card from the seed: each user's index item ids, its rows N(0, 1/F) as
    the engine's default init draws them, its mask the first len in [lo,
    D] columns or, ``holey``, about 60% of its columns in no order, every
    eighth user none, the ids where it is off past the catalog."""
    from cu2rec_torch.ops.packed import packed_width

    W = packed_width(n_f)
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.zeros((n_items, W), device=dev)
    table[:, :n_f + 1] = 0.1 * torch.randn((n_items, n_f + 1),
                                           generator=gen, device=dev)
    table = table.to(dtype)
    sets = []
    for _ in range(n_sets):
        T_u = torch.zeros((B, W), device=dev)
        T_u[:, :n_f + 1] = torch.randn((B, n_f + 1), generator=gen,
                                       device=dev) / n_f
        index = torch.randint(0, n_items, (B, D), generator=gen,
                              device=dev, dtype=torch.int32)
        vals = torch.randint(1, 11, (B, D), generator=gen,
                             device=dev).float() / 2
        if holey:
            mask = torch.rand((B, D), generator=gen, device=dev) < 0.6
            mask[3::8] = False
            index = torch.where(mask, index, n_items + 7)
        else:
            lens = torch.randint(lo, D + 1, (B, 1), generator=gen,
                                 device=dev)
            mask = torch.arange(D, device=dev)[None, :] < lens
        sets.append((T_u, table, index, vals, mask))
    return sets


def _sampled_rows(torch, key, index, mask, n_steps: int) -> int:
    """The distinct table rows a fold-in of ``n_steps`` iterations samples
    (the draws of ``fold_in_steps``)."""
    from cu2rec_torch.ops.sgd import counter_uniform
    from cu2rec_torch.serve.engine import compact_ratings

    index, _, lens = compact_ratings(index.long(), index, mask)
    slots = torch.arange(index.shape[0], device=index.device)
    rows = []
    for t in range(n_steps):
        pos = torch.minimum((counter_uniform(key, t, slots) * lens).long(),
                            (lens - 1).clamp(min=0))
        rows.append(torch.gather(index, 1, pos[:, None])[lens > 0])
    return int(torch.unique(torch.cat(rows)).numel())


def _shifted_plain(args, mu, hp, key, n_steps: int, n_f: int):
    """The planted fault: ``fold_in_steps`` with its iteration counter
    shifted by one (iteration t draws as t + 1 does)."""
    from cu2rec_torch.serve import engine

    draw = engine.counter_uniform
    engine.counter_uniform = lambda k, t, ids: draw(k, t + 1, ids)
    try:
        return engine.fold_in_steps(*args, mu, hp, key, n_steps, n_f)
    finally:
        engine.counter_uniform = draw


def _fold_err(torch, got, want) -> float:
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def phase_foldin_kernel(torch, dev, seed: int, card: str):
    """K0c against its plain version (``serve/engine.py::fold_in_steps``)
    in every case of FOLD_CASES, float32 and bf16 catalogs, the catalog
    sampled directly (one shard) and, for a float32 catalog, through the
    rows assembled once (several shards; an id past the catalog a row of
    zeros, as ``_rows`` assembles it): one iteration within FOLD_ONE_ATOL,
    the whole fold-in within FOLD_RTOL of max(1, |entry|), and a plain run
    whose iteration counter is shifted by one rejected; each timed with
    CUDA events (the stream held) beside the plain version, the byte bound
    of what it reads and the dependent-chain floor (every slot sampling
    its own row, which stays in L2).  Returns the kernel's entry."""
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.ops.cuda_foldin import fold_in_cuda
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.serve.engine import fold_in_steps

    hp, key, mu = _hp(), prng_key(seed + 14), 3.5
    entry, cases = None, {}
    for label, n_items, n_f, B, D, lo, n_steps, holey in FOLD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            sets = _fold_inputs(torch, dev, seed, n_items, n_f, B, D, lo,
                                dtype, FOLD_SETS, holey)
            sources = [("direct", sets)]
            if dtype == torch.float32:
                assembled = []
                for T_u, table, index, vals, mask in sets[:1]:
                    ids = index.reshape(-1).long()
                    rows = torch.where((ids < n_items)[:, None], table[
                        ids.clamp(max=n_items - 1)].float(), 0.0)
                    flat = torch.arange(B * D, dtype=torch.int32,
                                        device=dev).reshape(B, D)
                    assembled.append((T_u, rows, flat, vals, mask))
                sources.append(("assembled", assembled))
            for source, batches in sources:
                args = batches[0]
                one = _fold_err(torch, fold_in_cuda(*args, mu, hp, key, 1,
                                                    n_f),
                                fold_in_steps(*args, mu, hp, key, 1, n_f))
                got = fold_in_cuda(*args, mu, hp, key, n_steps, n_f)
                want = fold_in_steps(*args, mu, hp, key, n_steps, n_f)
                err = _fold_err(torch, got, want)
                fault = _fold_err(torch, got, _shifted_plain(
                    args, mu, hp, key, n_steps, n_f))
                empty = ~args[4].any(dim=1)
                tag = f"{label} {_dtype_name(dtype)} {source}"
                require(one <= FOLD_ONE_ATOL, f"foldin {tag}: one iteration "
                        f"differs from the plain version by {one:.3e}")
                require(err <= FOLD_RTOL, f"foldin {tag}: {n_steps} "
                        f"iterations differ from the plain version by "
                        f"{err:.3e} of max(1, |entry|)")
                require(fault > FOLD_RTOL, f"foldin {tag}: the check does "
                        f"not reject a counter shifted by one ({fault:.3e})")
                require(torch.equal(got[empty], args[0][empty])
                        and bool(torch.isfinite(got).all()),
                        f"foldin {tag}: empty slots moved or rows not finite")
                run = (lambda *a, n=n_steps, f=n_f:
                       fold_in_cuda(*a, mu, hp, key, n, f))
                ms = time_ms(run, batches, reps=40, hold=True)
                plain_ms = time_ms(lambda *a, n=n_steps, f=n_f: fold_in_steps(
                    *a, mu, hp, key, n, f), batches[:1], reps=2, warm=1)
                T_u, table, index, vals, mask = args
                own = torch.arange(B, dtype=torch.int32, device=dev)[
                    :, None].expand(B, D).contiguous()
                floor_ms = time_ms(run, [(T_u, table, own, vals, mask)],
                                   reps=40, hold=True)
                elem = table.element_size()
                distinct = statistics.mean(
                    _sampled_rows(torch, key, b[2], b[4], n_steps)
                    for b in batches)
                W = T_u.shape[1]
                n_bytes = (2 * B * W * 4 + 2 * B * D * 4 + B * D
                           + distinct * (n_f + 1) * elem)
                n_ops = 6 * (n_f + 1) * n_steps * int((~empty).sum())
                bound_ms, bound_by = _bound(n_bytes, n_ops)
                case = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "floor_ms": floor_ms, "one_err": one, "err": err,
                        "fault_err": fault, "items": n_items, "F": n_f,
                        "B": B, "Dp": D, "n_steps": n_steps}
                cases[tag] = case
                log(f"[foldin] {tag} ({n_items} items, F={n_f}, B={B}, Dp="
                    f"{D}, {n_steps} iterations, "
                    f"{int(empty.sum())} empty slots): {ms:.4f} ms (the "
                    f"stream held, {len(batches)} sets), "
                    f"{ms * 1e3 / n_steps:.3f} "
                    f"us an iteration; the chain floor (every slot sampling "
                    f"its own row, kept in L2) {floor_ms:.4f} ms; plain "
                    f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
                    f"{n_bytes / 1e6:.2f} MB, {distinct:.0f} distinct rows "
                    f"sampled); one iteration within {one:.3e}, the whole "
                    f"fold-in within {err:.3e} of max(1, |entry|), the "
                    f"shifted counter off by {fault:.3e} (rejected); {card}")
                if entry is None:
                    entry = _entry(
                        "foldin", _tpu_kernel_site(
                            "serve/engine.py", "    def _foldin_program"),
                        float((got - want).abs().max()), ms, plain_ms,
                        n_bytes, n_ops, None,
                        {"items": n_items, "F": n_f, "W": W, "B": B,
                         "Dp": D, "n_steps": n_steps, "dtype": "float32",
                         "source": source}, semantics="_foldin_program")
                    entry["floor_ms"] = floor_ms
            del sets, sources
        torch.cuda.empty_cache()
    entry["cases"] = cases
    return [entry]


# K5, a model's starting tables drawn on the card, at the plans the port's
# paths draw: the headline model (phase 5's mf, phase 7's families; float32
# and bf16), ML-20M at F = 50 and Netflix at F = 300 (the benchmark's SGD
# cells): (label, users, items, F, dtype).  The plain version (NumPy) is
# timed at ML-20M only: at Netflix it takes tens of seconds.
DRAW_CASES = (("headline", U, I, F, "float32"),
              ("headline-bf16", U, I, F, "bfloat16"),
              ("ml20m-f50", 138_493, 26_744, 50, "float32"),
              ("netflix-f300", 480_189, 17_770, 300, "float32"))
DRAW_PLAIN = "ml20m-f50"


def phase_draw_kernel(torch, dev, seed: int, card: str):
    """K5 at ``DRAW_CASES``: ``normal_draw_cuda`` on card tensors equal
    under ``torch.equal`` to ``init_model``'s CPU draw (``torch.randn`` on a
    seeded CPU generator) and, at ``DRAW_PLAIN``, to its plain version; each
    timed with the stream held beside its bound (``draw_bytes``), its
    MT19937 walk alone, torch's CUDA ``randn`` of the same sizes (Philox:
    other numbers, the library's cost of a draw on the card) and the CPU
    draw it replaces.  Returns its ``{"kernels"}`` entry."""
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.experiments.draw_times import draw_bytes
    from cu2rec_torch.models.state import init_model, table_dtype
    from cu2rec_torch.ops import cuda_draw

    t0 = time.perf_counter()
    r, cs = cuda_draw.device_tables(dev)
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    log(f"[draw] K5's transforms loaded or built, uploaded and checked in "
        f"{tables_s:.3f} s (cache {cuda_draw.cache_path().name})")
    lib = cuda_draw._load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases, entry = {}, None
    for i, (label, n_users, n_items, n_f, dtype_name) in \
            enumerate(DRAW_CASES):
        dtype = table_dtype(dtype_name)
        case_seed = seed + 2 ** 40 + i
        plan = cuda_draw.draw_plan([("P", n_users * n_f),
                                    ("Q", n_items * n_f),
                                    ("user_bias", n_users),
                                    ("item_bias", n_items)])
        outs = [torch.empty(e.n, dtype=dtype, device=dev) for e in plan]
        cuda_draw.normal_draw_cuda(case_seed, plan, outs, r, cs, n_f)
        got = [o.cpu() for o in outs]
        t0 = time.perf_counter()
        want = init_model(n_users, n_items, n_f, 3.5, seed=case_seed,
                          dtype=dtype, device="cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        for e, g, w in zip(plan, got, (want.P, want.Q, want.user_bias,
                                       want.item_bias)):
            diff = (g.float() - w.reshape(-1).float()).abs()
            require(torch.equal(g, w.reshape(-1)),
                    f"K5 {label} table {e.name}: {int((diff > 0).sum())} of "
                    f"{e.n} entries differ from the CPU draw (first at "
                    f"{int(torch.nonzero(diff > 0)[0]) if diff.any() else -1})")
        del want
        plain_ms = None
        if label == DRAW_PLAIN:
            host = [torch.empty(e.n, dtype=dtype) for e in plan]
            t0 = time.perf_counter()
            cuda_draw.draw_reference(case_seed, plan, host, r.cpu(),
                                     cs.cpu(), n_f)
            plain_ms = (time.perf_counter() - t0) * 1e3
            require(all(torch.equal(h, g) for h, g in zip(host, got)),
                    f"K5 {label}: the plain version differs from the kernel")
            del host
        del got
        ms = time_ms(lambda: cuda_draw.normal_draw_cuda(
            case_seed, plan, outs, r, cs, n_f), [()], reps=5, hold=True)
        n_chunks = -(-cuda_draw.plan_words(plan) // cuda_draw.CHUNK)
        windows = torch.empty((n_chunks, cuda_draw.MT_N), dtype=torch.int32,
                              device=dev)
        walk_ms = time_ms(lambda: lib.normal_draw_windows(
            case_seed & 0xFFFFFFFF, n_chunks, windows.data_ptr(), stream),
            [()], reps=5, hold=True)
        gen = torch.Generator(device=dev).manual_seed(case_seed)
        library_ms = time_ms(lambda: [
            torch.randn(e.n, generator=gen, device=dev).div_(n_f).to(dtype)
            for e in plan], [()], reps=5, hold=True)
        entries = sum(e.n for e in plan)
        n_bytes = draw_bytes(plan, torch.finfo(dtype).bits // 8)
        n_ops = 3 * entries      # a product, the + 0 and the division
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        cases[label] = {"users": n_users, "items": n_items, "F": n_f,
                        "dtype": dtype_name,
                        "words": cuda_draw.plan_words(plan),
                        "chunks": n_chunks, "ms": ms, "walk_ms": walk_ms,
                        "bound_ms": bound_ms, "library_ms": library_ms,
                        "cpu_draw_ms": cpu_ms, "plain_ms": plain_ms}
        log(f"[draw] {label} ({n_users} x {n_items}, F={n_f}, {dtype_name}, "
            f"{cuda_draw.plan_words(plan)} words): equal to the CPU draw; "
            f"{ms:.4f} ms (the stream held), the walk {walk_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB); "
            f"torch's CUDA randn {library_ms:.4f} ms; the CPU draw it "
            f"replaces {cpu_ms:.1f} ms"
            + ("" if plain_ms is None else f"; plain {plain_ms:.1f} ms")
            + f"; {card}")
        if label == DRAW_PLAIN:
            entry = _entry(
                "normal_draw", _tpu_kernel_site(
                    "models/state.py", "def init_model"), 0.0, ms, plain_ms,
                n_bytes, n_ops, library_ms,
                {"users": n_users, "items": n_items, "F": n_f,
                 "dtype": dtype_name}, semantics="init_model (its "
                "Normal(0, 1/F) tables, drawn with the numbers of torch's "
                "CPU generator)")
        del outs, windows
        torch.cuda.empty_cache()
    entry["tables_s"] = tables_s
    entry["cases"] = cases
    return [entry]


@contextmanager
def _draws(counts: dict, label: str):
    """K5's launches and ``init_model``'s ``model.init.card_draws`` and
    ``.cpu_draws`` over one main-path phase, counted from 0 just before it
    (the program's recorder on for the phase), into ``counts[label]``."""
    from cu2rec_torch.ops import cuda_draw
    from cu2rec_torch.utils import timing

    cuda_draw.LAUNCHES.clear()
    timing.trace_start()
    try:
        yield
    finally:
        got = timing.trace_stop()["counters"]
    counts[label] = {"normal_draw": cuda_draw.LAUNCHES.total(),
                     "card_draws": got.get("model.init.card_draws", 0),
                     "cpu_draws": got.get("model.init.cpu_draws", 0)}
    log(f"[draws] {label}: {counts[label]}")


# -- phase 5: train, predict and probe through the entry points -------------

def _planted(seed: int, workdir: Path):
    """Train and test CSVs of a planted model at the headline widths: rank-20
    factors plus user and item biases plus noise.  Returns the paths and
    the test RMSE of the global-mean predictor."""
    rng = np.random.default_rng(seed + 3)
    P = rng.normal(0, 0.3, (U, RANK))
    Q = rng.normal(0, 0.3, (I, RANK))
    bu, bi = rng.normal(0, 0.3, U), rng.normal(0, 0.3, I)
    n = TRAIN_RATINGS + TEST_RATINGS
    users = np.concatenate([np.arange(U), rng.integers(0, U, n - U)])
    rng.shuffle(users)
    items = rng.integers(0, I, n)
    r = (3.5 + bu[users] + bi[items] + rng.normal(0, 0.3, n)
         + np.einsum("nk,nk->n", P[users], Q[items]))
    paths = []
    for name, sl in (("train", slice(0, TRAIN_RATINGS)),
                     ("test", slice(TRAIN_RATINGS, n))):
        order = np.argsort(users[sl], kind="stable")
        path = workdir / f"{name}.csv"
        with open(path, "w") as f:
            f.write("userId,itemId,rating\n")
            np.savetxt(f, np.column_stack([users[sl][order] + 1,
                                           items[sl][order] + 1,
                                           r[sl][order]]),
                       fmt=["%d", "%d", "%.4f"], delimiter=",")
        paths.append(str(path))
    mu = float(np.mean(np.round(r[:TRAIN_RATINGS], 4)))
    mean_rmse = float(np.sqrt(np.mean((np.round(r[TRAIN_RATINGS:], 4)
                                       - mu) ** 2)))
    return paths, mean_rmse


def _capture(main, args):
    """Run a CLI's ``main`` with its standard output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    require(rc == 0, f"{main.__module__} exited with {rc}")
    return buf.getvalue()


def _export_split(t_loop: float, csv_dir: Path, base: str, ckpt: Path):
    """(CSV seconds, checkpoint seconds) of an ``mf`` export, from the end
    of its loop (the JSONL time record) and the files' modification times:
    the five component CSVs are written first, then the checkpoint."""
    last_csv = max((csv_dir / f"{base}{c}.csv").stat().st_mtime
                   for c in ("p", "q", "user_bias", "item_bias",
                             "global_bias"))
    return last_csv - t_loop, ckpt.stat().st_mtime - last_csv


METRIC_LINE = re.compile(
    r"^(TRAIN|TEST): Iteration (\d+) [GC]PU MAE: (\d+\.\d+) RMSE: "
    r"(\d+\.\d+)$")


def phase_train(torch, seed: int, workdir: Path, card: str,
                device: str = "cuda"):
    from cu2rec_torch.cli import mf
    from cu2rec_torch.ops import cuda_loss, cuda_sgd

    t0 = time.perf_counter()
    (train, test), mean_rmse = _planted(seed, workdir)
    log(f"[train] planted data: {U} users x {I} items, rank {RANK}, "
        f"{TRAIN_RATINGS} train and {TEST_RATINGS} test ratings "
        f"({time.perf_counter() - t0:.1f} s); global-mean test RMSE "
        f"{mean_rmse:.6f}")
    cfg = workdir / "train.cfg"
    # cur total F lr seed P_reg Q_reg ub_reg ib_reg n_threads check_error
    # patience lr_decay
    cfg.write_text(f"0 {TRAIN_ITERATIONS} {F} 0.05 {seed} 0.02 0.02 0.02 "
                   f"0.02 32 100 2 0.2\n")
    out = workdir / "out"
    jsonl = workdir / "metrics.jsonl"
    cuda_sgd.LAUNCHES.clear()
    cuda_loss.LAUNCHES.clear()
    t0, t_start = time.perf_counter(), time.time()
    text = _capture(mf.main, ["-c", str(cfg), train, test, "--outdir",
                              str(out), "--checkpoint",
                              str(workdir / "model.npz"), "--jsonl",
                              str(jsonl), "--device", device])
    wall, t_end = time.perf_counter() - t0, time.time()
    launches = {"sgd_step": cuda_sgd.LAUNCHES.total(),
                "eval_error": cuda_loss.LAUNCHES.total()}
    for line in text.splitlines():
        log(f"[train] {line}")
    metrics = [METRIC_LINE.match(ln) for ln in text.splitlines()
               if ln.startswith(("TRAIN:", "TEST:"))]
    require(metrics and all(metrics), "a TRAIN/TEST line does not parse")
    test_rmse = [(int(m[2]), float(m[4])) for m in metrics
                 if m[1] == "TEST"]
    require([it for it, _ in test_rmse] == [1, 100, 200, 300],
            f"eval points {test_rmse}")
    final, first = test_rmse[-1][1], test_rmse[0][1]
    require(final < first and final < mean_rmse,
            f"test RMSE {final} is not below iteration 1's {first} and the "
            f"global mean's {mean_rmse}")
    base = f"train_f{F}_"
    for comp in ("p", "q", "user_bias", "item_bias", "global_bias"):
        require((out / f"{base}{comp}.csv").exists(), f"{comp} CSV missing")
    require(device == "cpu" or (launches["sgd_step"] > 0
                                and launches["eval_error"] > 0),
            f"the training run did not launch both kernels: {launches}")
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    rates = [(r["iteration"], r["updates_per_s"]) for r in recs
             if r["event"] == "eval"]
    # The metric records' host timestamps split the run: set-up (CSV read,
    # upload, warm-up) up to the first eval, the training loop up to the
    # time record, then the CSV and checkpoint export.
    t_eval1 = next(r["ts"] for r in recs if r["event"] == "eval")
    t_loop = next(r["ts"] for r in recs if r["event"] == "time")
    csv_s, ckpt_s = _export_split(t_loop, out, base, workdir / "model.npz")
    log(f"[train] mf on {card}: {wall:.1f} s wall: set-up and first eval "
        f"{t_eval1 - t_start:.2f} s, iterations 2-{TRAIN_ITERATIONS} with "
        f"their evals {t_loop - t_eval1:.3f} s, export "
        f"{t_end - t_loop:.2f} s: CSVs {csv_s:.2f} s, checkpoint "
        f"{ckpt_s:.2f} s (the per-value Python writer's export took "
        f"{PYTHON_EXPORT_S} s on an NVIDIA H100 80GB HBM3 at 700 W); test RMSE {first:.6f} at iteration 1 -> "
        f"{final:.6f} at {TRAIN_ITERATIONS} (global mean {mean_rmse:.6f}); "
        f"launches {launches}; user updates/s per segment (host clock, the "
        f"segment's train eval included): {rates}")
    return launches, out, final


def _predictions(text: str):
    lines = text.splitlines()
    k = lines.index("Predictions: ")
    scores = np.array([float(x) for x in
                       lines[k + 1].strip("[], ").split(",")])
    ranks = [(int(ln.split("Item:")[1].split()[0]),
              float(ln.split("rating:")[1])) for ln in lines
             if ln.startswith("Rank:")]
    return scores, ranks


def phase_predict(seed: int, workdir: Path, out: Path, card: str,
                  device: str = "cuda"):
    from cu2rec_torch.cli import predict
    from cu2rec_torch.ops import cuda_gram, cuda_linalg, cuda_sgd

    rng = np.random.default_rng(seed + 4)
    rated = rng.choice(I, 20, replace=False)
    user = workdir / "user.csv"
    user.write_text("userId,itemId,rating\n" + "".join(
        f"1,{i + 1},{r}\n" for i, r in
        zip(sorted(rated), rng.integers(1, 11, 20) / 2.0)))
    args = ["-c", str(workdir / "train.cfg"),
            "-i", str(out / f"train_f{F}_item_bias.csv"),
            "-g", str(out / f"train_f{F}_global_bias.csv"),
            "-q", str(out / f"train_f{F}_q.csv"), str(user),
            "--device", device]
    launches = {}
    for mode, extra in (
            ("explicit", []),
            ("implicit", ["--implicit", "--alpha", "40", "--reg", "0.1"])):
        cuda_sgd.LAUNCHES.clear()
        cuda_linalg.LAUNCHES = cuda_gram.LAUNCHES = 0
        t0 = time.perf_counter()
        text = _capture(predict.main, args + extra)
        wall = time.perf_counter() - t0
        launches[mode] = (cuda_sgd.LAUNCHES.total() if mode == "explicit"
                          else cuda_linalg.LAUNCHES)
        if mode == "implicit":
            launches["implicit_gram"] = cuda_gram.LAUNCHES
            require(device == "cpu" or cuda_gram.LAUNCHES > 0,
                    "implicit predict launched no gather_gram")
        scores, ranks = _predictions(text)
        require(len(scores) == I and np.all(np.isfinite(scores)),
                f"{mode} predict: {len(scores)} predictions, want {I}")
        items = [i for i, _ in ranks]
        require(sorted(items) == sorted(set(range(I)) - set(rated.tolist())),
                f"{mode} predict: the ranking is not the unrated items")
        require(all(abs(s - scores[i]) <= 1e-4 * max(1.0, abs(s))
                    for i, s in ranks),
                f"{mode} predict: a rank's rating is not its prediction")
        ranked = scores[items]
        require(np.all(ranked[:-1] >= ranked[1:] - 1e-5 * np.maximum(
                    1.0, np.abs(ranked[1:]))),
                f"{mode} predict: the ranking is not sorted by prediction")
        require(device == "cpu" or launches[mode] > 0,
                f"{mode} predict launched no kernel")
        log(f"[predict] {mode}: {len(scores)} predictions, {len(ranks)} "
            f"ranked, rated items absent, {launches[mode]} kernel "
            f"launches (gather_gram {launches.get('implicit_gram', 0)}), "
            f"{wall:.2f} s wall on {card}")
    return launches


def phase_probes():
    from cu2rec_torch.experiments import gather_roofline, vmem_gather_probe
    from cu2rec_torch.ops.cuda_gather import row_gather, smem_gather

    row_gather.LAUNCHES = smem_gather.LAUNCHES = 0
    require(gather_roofline.main([]) == 0, "gather_roofline failed")
    require(vmem_gather_probe.main([]) == 0, "vmem_gather_probe failed")
    launches = {"row_gather": row_gather.LAUNCHES,
                "smem_gather": smem_gather.LAUNCHES}
    require(all(launches.values()), f"a probe launched no kernel: "
            f"{launches}")
    log(f"[probes] kernel launches {launches}")
    return launches


# -- phase 6: serve ----------------------------------------------------------

def _replay(wave, attempt: int = 0):
    """The same requests under new ids (one set of ids an attempt)."""
    return [dict(r, id=f"{r['id']}~prof{attempt}") for r in wave]


class _WaveInput:
    """The daemon's stdin: yields one wave of request lines, then waits
    until every response of that wave is written before the next wave
    (a closed loop, so each wave is one batch).  ``probe()`` (a launch
    count) is read as each wave starts and once its responses are out.
    Each wave is timed with no profiler running; then, except for the
    last (stats) wave, its replay runs under a profiler from
    ``profile()``, again under new ids while ``busy(profile)`` is false,
    at most PROFILE_TRIES times.  ``profiles`` holds (profile, start,
    attempt) of each wave's kept replay.  With ``profile`` None there are
    no replays."""

    def __init__(self, waves, out, probe, profile, busy):
        self.waves, self.out, self.probe = waves, out, probe
        self.profile, self.busy = profile, busy
        self.t_start: list[float] = []
        self.counts: list[tuple[int, int]] = []
        self.profiles: list = []

    def _send(self, wave):
        ids = {r["id"] for r in wave}
        for r in wave:
            yield json.dumps(r) + "\n"
        with self.out.cond:
            self.out.cond.wait_for(
                lambda: ids <= self.out.t_done.keys(), timeout=120)

    def __iter__(self):
        for n, wave in enumerate(self.waves):
            before = self.probe()
            self.t_start.append(time.perf_counter())
            yield from self._send(wave)
            self.counts.append((before, self.probe()))
            if n == len(self.waves) - 1 or self.profile is None:
                continue
            for attempt in range(PROFILE_TRIES):
                prof = self.profile()
                prof.start()
                t0 = time.perf_counter()
                yield from self._send(_replay(wave, attempt))
                prof.stop()
                if self.busy(prof):
                    break
            self.profiles.append((prof, t0, attempt))


def _union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
    return busy_us


def _launch_counts():
    """(K1's, K0c's, K4's launches) so far in this process: the probe
    ``_WaveInput`` reads as each wave starts and ends."""
    from cu2rec_torch.ops import cuda_foldin, cuda_gram, cuda_linalg

    return cuda_linalg.LAUNCHES, cuda_foldin.LAUNCHES, cuda_gram.LAUNCHES


def _wave_launches(inp, label: str):
    """(K1, K0c, K4) launches by serving wave (recommend, explicit fold-in,
    implicit fold-in) from ``_launch_counts`` probes: K1 and K4 by the
    implicit fold-ins only, K0c by the explicit fold-ins only."""
    k1, k0c, k4 = ([b[i] - a[i] for a, b in inp.counts[:3]]
                   for i in (0, 1, 2))
    for name, k in (("ridge_cholesky", k1), ("gather_gram", k4)):
        require(k[2] > 0, f"{label}: {name} was not launched by the "
                "implicit fold-ins")
        require(k[0] == k[1] == 0, f"{label}: {name} launched outside the "
                "implicit fold-ins")
    require(k0c[1] > 0, f"{label}: foldin was not launched by the explicit "
            "fold-ins")
    require(k0c[0] == k0c[2] == 0, f"{label}: foldin launched outside the "
            "explicit fold-ins")
    return k1, k0c, k4


def _device_breakdown(torch, prof, top: int = 6, outside: str | None = None):
    """(device busy seconds, [(kernel, ms, calls)] by device time) from one
    wave's profile: the union of the CUDA kernel intervals.  With
    ``outside``, the busy seconds are those outside the intervals of the
    kernels whose name holds it."""
    spans, by_name, inside = [], {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        if outside is not None and outside in e.name:
            inside.append((s, t))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t - s) / 1e3, n + 1)
    busy_us = _union_us(spans) - _union_us(inside)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy_us / 1e6, [(k, ms, n) for k, (ms, n) in ranked]


class _ResponseOutput:
    """The daemon's stdout: keeps each response and when it was written."""

    def __init__(self):
        self.cond = threading.Condition()
        self.resp: dict = {}
        self.t_done: dict = {}

    def write(self, s: str) -> int:
        for line in s.splitlines():
            if line.strip():
                r = json.loads(line)
                with self.cond:
                    self.resp[r.get("id")] = r
                    self.t_done[r.get("id")] = time.perf_counter()
                    self.cond.notify_all()
        return len(s)

    def flush(self) -> None:
        pass


def _serve_data(seed: int):
    """Random ML-20M-scale tables and user-sorted train ratings, from the
    seed: (tables, users, items, ratings)."""
    rng = np.random.default_rng(seed)
    tables = {
        "p": rng.normal(0, 0.1, (U, F)).astype(np.float32),
        "q": rng.normal(0, 0.1, (I, F)).astype(np.float32),
        "user_bias": rng.normal(0, 0.3, U).astype(np.float32),
        "item_bias": rng.normal(0, 0.3, I).astype(np.float32),
        "global_bias": np.array([3.5], np.float32),
    }
    users = np.sort(np.concatenate([np.arange(U),
                                    rng.integers(0, U, N_RATINGS - U)]))
    items = rng.integers(0, I, N_RATINGS)
    ratings = rng.integers(1, 11, N_RATINGS) / 2.0
    return tables, users, items, ratings


def _make_data(seed: int, workdir: Path):
    """``_serve_data``'s tables in an ``.npz`` (the port's
    ``save_checkpoint``) and its ratings in a train CSV."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.utils.checkpoint import save_checkpoint
    from cu2rec_torch.utils.config import Config

    tables, users, items, ratings = _serve_data(seed)
    ckpt = save_checkpoint(str(workdir / "model.npz"),
                           model_from_numpy(tables, device="cpu"),
                           Config(n_factors=F, total_iterations=100))
    train = workdir / "train.csv"
    with open(train, "w") as f:
        f.write("userId,itemId,rating\n")
        np.savetxt(f, np.column_stack([users + 1, items + 1, ratings]),
                   fmt=["%d", "%d", "%.1f"], delimiter=",")
    indptr = np.searchsorted(users, np.arange(U + 1))
    return tables, ckpt, str(train), indptr, items


def _requests(rng):
    rec_users = rng.choice(U, 512, replace=False)
    waves = [[{"id": "rec", "op": "recommend",
               "users": [int(u) for u in rec_users], "k": 10}]]
    for mode in ("sgd", "implicit"):
        wave = []
        for b in range(256):
            n = int(rng.integers(8, 65))
            items = rng.choice(I, n, replace=False)
            req = {"id": f"{mode}-{b}", "op": "fold_in",
                   "items": [int(i) for i in items], "k": 10}
            if mode == "sgd":
                req["ratings"] = [float(r) for r in
                                  rng.integers(1, 11, n) / 2.0]
                req["iterations"] = 100
            else:
                req.update(mode="implicit", alpha=40.0, reg=0.1,
                           ratings=[round(float(r), 3) for r in
                                    rng.random(n) * 5.0])
            wave.append(req)
        waves.append(wave)
    waves.append([{"id": "stats", "op": "stats"}])
    return rec_users, waves


def _check_topk(items, scores, ref_scores, excluded, what: str):
    """k items, none excluded, each score its item's float64 reference
    score, and the k scores the reference top-k scores."""
    require(len(items) == 10, f"{what}: {len(items)} items, want 10")
    require(not set(items) & set(excluded), f"{what}: a rated item came back")
    s = np.asarray(scores)
    require(np.all(np.isfinite(s)), f"{what}: non-finite scores")
    ref = ref_scores.copy()
    ref[list(excluded)] = -np.inf
    top = np.sort(ref)[::-1][:10]
    tol = 1e-3 * max(1.0, float(np.abs(top).max()))
    require(np.abs(ref[items] - s).max() <= tol,
            f"{what}: scores differ from the reference")
    require(np.abs(top - s).max() <= tol,
            f"{what}: not the reference top-10")


def _wave_times(waves, inp, out):
    """(latency of each of the three serving waves, requests/s)."""
    lat = [max(out.t_done[r["id"]] for r in w) - t
           for w, t in zip(waves[:3], inp.t_start[:3])]
    return lat, sum(len(w) for w in waves[:3]) / sum(lat)


def phase_serve(torch, seed: int, card: str, device: str = "cuda"):
    from cu2rec_torch.cli.serve import main as serve_main
    from cu2rec_torch.ops import cuda_foldin, cuda_gram, cuda_linalg

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        t0 = time.perf_counter()
        tables, ckpt, train, indptr, train_items = _make_data(
            seed, Path(tmp))
        log(f"[serve] data: {U} users x {I} items, F={F}, "
            f"{N_RATINGS} train ratings ({time.perf_counter() - t0:.1f} s)")
        rec_users, waves = _requests(rng)
        out = _ResponseOutput()
        inp = _WaveInput(waves, out, _launch_counts,
                         lambda: _new_profile(torch),
                         lambda prof: _has_device_time(torch, prof))
        saved = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = inp, out
        cuda_linalg.LAUNCHES = cuda_foldin.LAUNCHES = cuda_gram.LAUNCHES = 0
        t0 = time.perf_counter()
        try:
            # A 20 ms batching window (default 4) so that each wave of
            # requests forms one batch; the padded-signature ladder is run
            # once before traffic, as a deployment would (--warm-batch).
            rc = serve_main(["--checkpoint", ckpt, "--train", train,
                             "--device", device, "--window-ms", "20",
                             "--warm-batch", "512", "--warm-width", "64"])
        finally:
            sys.stdin, sys.stdout = saved
        launches = {"ridge_cholesky": cuda_linalg.LAUNCHES,
                    "foldin": cuda_foldin.LAUNCHES,
                    "gather_gram": cuda_gram.LAUNCHES}
        wall = time.perf_counter() - t0
    require(rc == 0, f"serve exited with {rc}")

    want = {r["id"] for w in waves for r in w} | {
        r["id"] for w, (_, _, attempt) in zip(waves, inp.profiles)
        for a in range(attempt + 1) for r in _replay(w, a)}
    require(want <= out.resp.keys(),
            f"missing responses: {sorted(want - out.resp.keys())[:5]}")
    errors = [r for r in out.resp.values() if "error" in r]
    require(not errors, f"error responses: {errors[:3]}")
    stats = out.resp["stats"]
    require(stats["device"].startswith("cuda"),
            f"the engine's tables are on {stats['device']}")
    per_wave, k0c_wave, k4_wave = _wave_launches(inp, "serve")

    Q = tables["q"].astype(np.float64)
    ib = tables["item_bias"].astype(np.float64)
    mu = float(tables["global_bias"][0])
    results = out.resp["rec"]["results"]
    require(len(results) == 512, "recommend: wrong number of results")
    for b, u in enumerate(rec_users):
        rated = train_items[indptr[u]:indptr[u + 1]]
        ref = (Q @ tables["p"][u].astype(np.float64) + mu
               + float(tables["user_bias"][u]) + ib) if b < 32 else None
        if ref is None:
            require(len(results[b]["items"]) == 10
                    and not set(results[b]["items"]) & set(rated.tolist()),
                    f"recommend user {u}: wrong items")
            continue
        _check_topk(results[b]["items"], results[b]["scores"], ref,
                    rated.tolist(), f"recommend user {u}")
    for req in waves[1]:
        r = out.resp[req["id"]]
        require(len(r["items"]) == 10 and np.all(np.isfinite(r["scores"]))
                and not set(r["items"]) & set(req["items"]),
                f"fold_in {req['id']}: wrong items")
    G0 = Q.T @ Q
    for n, req in enumerate(waves[2]):
        r = out.resp[req["id"]]
        if n >= 32:
            require(len(r["items"]) == 10
                    and not set(r["items"]) & set(req["items"]),
                    f"fold_in {req['id']}: wrong items")
            continue
        q = Q[req["items"]]
        s = np.asarray(req["ratings"], np.float64)
        G = G0 + (q * (40.0 * s)[:, None]).T @ q + 0.1 * np.eye(F)
        x = np.linalg.solve(G, q.T @ (1.0 + 40.0 * s))
        _check_topk(r["items"], r["scores"], Q @ x + mu + ib, req["items"],
                    f"implicit fold_in {req['id']}")

    lat, rps = _wave_times(waves, inp, out)
    log(f"[serve] {sum(len(w) for w in waves[:3])} requests in 3 batches: "
        "recommend "
        f"{lat[0] * 1e3:.1f} ms, explicit fold-in {lat[1] * 1e3:.1f} ms, "
        f"implicit fold-in {lat[2] * 1e3:.1f} ms; p50 batch latency "
        f"{float(np.median(lat)) * 1e3:.1f} ms; {rps:.1f} requests/s "
        f"(serving waves only, no profiler; {wall:.1f} s with model load "
        f"and the profiled replays) on {card}")
    log(f"[serve] launches in the run (warm-up ladder and replays "
        f"included): {launches}; by wave (recommend, explicit, implicit) "
        f"ridge_cholesky {per_wave}, foldin {k0c_wave}, gather_gram "
        f"{k4_wave}; stats: "
        f"{json.dumps(stats)}")
    for what, (prof, t0, attempt), wave, wave_s in zip(
            ("recommend", "explicit fold-in", "implicit fold-in"),
            inp.profiles, waves, lat):
        replay_s = max(out.t_done[r["id"]]
                       for r in _replay(wave, attempt)) - t0
        busy_s, top = _device_breakdown(torch, prof)
        require(top, f"profile of the {what} wave holds no device time")
        if attempt:
            log(f"[profile] {what}: replay {attempt + 1} of "
                f"{PROFILE_TRIES}, the earlier sessions recorded no device "
                "time")
        log(f"[profile] {what}: device busy {busy_s * 1e3:.3f} ms, "
            f"{busy_s / replay_s:.1%} of the profiled replay's "
            f"{replay_s * 1e3:.1f} ms, {busy_s / wave_s:.1%} of the "
            f"unprofiled wave's {wave_s * 1e3:.1f} ms;"
            " top kernels by device time: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in top))
    return launches, {"tables": tables, "indptr": indptr,
                      "train_items": train_items, "waves": waves,
                      "resp": out.resp, "lat": lat, "rps": rps}


# -- phase 7: the training families (ALS, iALS, BPR) -----------------------

# ALS's explicit planted draws at the headline shape (about 20,000,000 train
# and 2,200,000 test ratings after the 90/10 split), its sweeps and regs.
ALS_DRAWS, SWEEPS, FAMILY_REG = 22_200_000, 5, 0.05
HEAVY_DEGREE, MIN_HEAVY = 8192, 100      # the heavy path's edge; a gate
IMPLICIT_DRAWS, ALPHA = 20_000_000, 40.0
IALS_AUC_GATE, RECALL_GATE_X = 0.65, 5   # recall@10 ≥ 5 × a random 10 / I
# BPR's iterations: at this shape 500 left AUC at 0.587 on an H100, below
# its gate, so the run takes 2,000; the gate stays.
BPR_ITERATIONS, BPR_CHECK, BPR_LR, BPR_REG, BPR_AUC_GATE = \
    2000, 1000, 0.1, 0.01, 0.6
# The entry points' planted CSVs: ML-100K's shape.
ML100K = (943, 1682, 100_000)
IMPLICIT_LINE = re.compile(
    r"^(IALS sweep|BPR iteration) (\d+): AUC = (\d+\.\d+)  recall@\d+ = "
    r"(\d+\.\d+)  ndcg@\d+ = (\d+\.\d+)$")


def _implicit_metrics(text: str):
    """[(iteration, auc, recall, ndcg)] of the implicit metric lines of a
    run's output; fails if a line that starts like one does not parse."""
    rows = []
    for line in text.splitlines():
        if line.startswith(("IALS sweep", "BPR iteration")):
            m = IMPLICIT_LINE.match(line)
            require(m, f"an implicit metric line does not parse: {line!r}")
            rows.append((int(m[2]), float(m[3]), float(m[4]), float(m[5])))
    require(rows, "no implicit metric line")
    return rows


def _history_rows(logger):
    """The same rows from a MetricsLogger's implicit eval records."""
    return [(r["iteration"], r["auc"], r["recall_at_k"], r["ndcg_at_k"])
            for r in logger.history if r["event"] == "eval"]


def _gate_als(test_rmse, mean_rmse: float) -> None:
    """The last sweep's test RMSE below the first's and the global mean's."""
    first, last = test_rmse[0], test_rmse[-1]
    require(last < first and last < mean_rmse,
            f"ALS test RMSE {last} is not below sweep 1's {first} and the "
            f"global mean's {mean_rmse}")


def _gate_ials(rows, n_items: int) -> None:
    _it, auc, recall, _ndcg = rows[-1]
    need = RECALL_GATE_X * 10 / n_items
    require(auc >= IALS_AUC_GATE and recall >= need,
            f"iALS at sweep {_it}: AUC {auc} (need {IALS_AUC_GATE}), "
            f"recall@10 {recall} (need {need:.5f})")


def _gate_bpr(rows) -> None:
    first, last = rows[0][1], rows[-1][1]
    require(last >= BPR_AUC_GATE and last > first,
            f"BPR AUC {last} at iteration {rows[-1][0]} is not >= "
            f"{BPR_AUC_GATE} and above iteration {rows[0][0]}'s {first}")


def _csr_of_keys(keys, n_users: int, n_items: int):
    """A host CSR of sorted unique keys user·I + item, every rating 1."""
    from cu2rec_torch.data.csr import CSRRatings

    keys = keys.cpu().numpy()
    users = keys // n_items
    indptr = np.zeros(n_users + 1, np.int32)
    np.cumsum(np.bincount(users, minlength=n_users), out=indptr[1:])
    return CSRRatings(indptr=indptr,
                      indices=(keys % n_items).astype(np.int32),
                      data=np.ones(len(keys), np.float32),
                      n_users=n_users, n_items=n_items)


def _implicit_on_card(torch, n_users: int, n_items: int, n_draws: int,
                      n_factors: int, seed: int, dev, chunk_users=2048,
                      oracle_samples=200_000, signal_std=2.0, bias_std=0.45,
                      test_share=0.1):
    """The recipe of ``data/synth.py::generate_planted_implicit`` on the
    device (its NumPy copy takes minutes at the headline shape): lognormal
    user activity, each user's items drawn from a softmax over p·q + b by a
    searchsorted on the float64 cumsum, repeated pairs dropped, and the
    oracle AUC by Monte Carlo.  The kept pairs split at random, about
    ``test_share`` to test.  Returns (train CSR, test CSR, oracle AUC)."""
    f64 = torch.float64
    g = torch.Generator(device=dev).manual_seed(seed)
    U, I = n_users, n_items
    s = (signal_std ** 2 / n_factors) ** 0.25
    P = torch.randn((U, n_factors), generator=g, device=dev) * s
    Q = torch.randn((I, n_factors), generator=g, device=dev) * s
    ib = torch.randn(I, generator=g, device=dev) * bias_std
    w_u = torch.exp(torch.randn(U, generator=g, device=dev, dtype=f64))
    cdf_u = torch.cumsum(w_u / w_u.sum(), 0)
    drawn_u = torch.searchsorted(cdf_u, torch.rand(n_draws, generator=g,
                                                   device=dev, dtype=f64))
    counts = torch.bincount(drawn_u.clamp(max=U - 1), minlength=U)
    keys, hits, total = [], 0, 0
    per_chunk = max(1, oracle_samples // max(1, U // chunk_users))
    for lo in range(0, U, chunk_users):
        hi = min(lo + chunk_users, U)
        c = hi - lo
        logits = P[lo:hi] @ Q.T + ib
        w = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
        cdf = torch.cumsum(w, dim=1, dtype=f64)
        cdf /= cdf[:, -1:].clone()
        flat = (cdf + torch.arange(c, device=dev, dtype=f64)[:, None]) \
            .reshape(-1)
        rows = torch.repeat_interleave(torch.arange(c, device=dev),
                                       counts[lo:hi])
        u01 = torch.rand(rows.shape[0], generator=g, device=dev, dtype=f64)
        items = (torch.searchsorted(flat, u01 + rows) - rows * I).clamp(
            0, I - 1)
        keys.append((rows + lo) * I + items)
        m = min(per_chunk, c)
        sel = torch.randint(0, c, (m,), generator=g, device=dev)
        su = torch.rand(m, generator=g, device=dev, dtype=f64) + sel
        pos = (torch.searchsorted(flat, su) - sel * I).clamp(0, I - 1)
        neg = torch.randint(0, I, (m,), generator=g, device=dev)
        a = P[lo + sel]
        s_pos = (a * Q[pos]).sum(-1) + ib[pos]
        s_neg = (a * Q[neg]).sum(-1) + ib[neg]
        hits += int((s_pos > s_neg).sum())
        total += m
    keys = torch.unique(torch.cat(keys))
    test = torch.rand(keys.shape[0], generator=g, device=dev) < test_share
    return (_csr_of_keys(keys[~test], U, I),
            _csr_of_keys(keys[test], U, I), hits / max(1, total))


def _explicit_family_data(seed: int):
    """``generate_planted`` at the headline shape, split 90/10: (train CSR,
    test CSR, train mean, the global-mean predictor's test RMSE)."""
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.data.synth import generate_planted, split_arrays

    d = generate_planted(U, I, ALS_DRAWS, seed=seed)
    csrs = []
    for u, i, r in split_arrays(d.users, d.items, d.ratings, 0.9, seed=seed):
        indptr = np.zeros(U + 1, np.int32)
        np.cumsum(np.bincount(u, minlength=U), out=indptr[1:])
        csrs.append(CSRRatings(indptr=indptr, indices=i, data=r,
                               n_users=U, n_items=I))
    mu = float(np.mean(csrs[0].data))
    mean_rmse = float(np.sqrt(np.mean((csrs[1].data.astype(np.float64)
                                       - mu) ** 2)))
    return csrs[0], csrs[1], mu, mean_rmse


def _family_cfg(seed: int, **kw):
    from cu2rec_torch.utils.config import Config

    return Config(n_factors=F, total_iterations=SWEEPS, seed=seed,
                  P_reg=FAMILY_REG, Q_reg=FAMILY_REG,
                  user_bias_reg=FAMILY_REG, item_bias_reg=FAMILY_REG)\
        .replace(**kw)


# K4 against its plain version: elementwise within 1e-5 of the same sum of
# absolute values (``gram_scale``, the epilogue's terms added) + 1e-6,
# float32 sums of up to 8,192 terms in another order.  The gate holds K4
# against the plain version evaluated in float64: on a trained heavy ALS
# chunk the float32 plain version (gather + bmm) is itself further than
# that from the exact sums (each ``[gram]`` line prints how far), so its
# distance to K4 is printed beside the gate, not gated.
GRAM_RTOL, GRAM_ATOL = 1e-5, 1e-6


def _gram_cases(torch, chunks, T_other, family: str, mu: float = 0.0):
    """The ``gather_gram`` arguments of a half sweep's largest regular chunk
    (by slots) and of its first heavy chunk, as the sweep passes them:
    {kind: (args, kwargs, epilogue)}."""
    from cu2rec_torch.ops import als
    from cu2rec_torch.ops.cuda_gram import gram_rows
    from cu2rec_torch.ops.ials import gramian

    regs, heavies = als.split_chunks(chunks)
    picked = {"regular": max(regs, key=lambda ch: ch[0].numel())}
    if heavies:
        picked["heavy"] = heavies[0]
    dev = T_other.device
    if family == "als":
        Tx = als.design_table(T_other, F)
        rows, n = Tx.rows, F + 1
        mode = dict(mu=torch.tensor(mu, device=dev))
        reg = als.reg_vector(FAMILY_REG, FAMILY_REG, F, dev)
    else:
        rows, n = gram_rows(T_other), F
        mode = dict(alpha=ALPHA)
        G_global = gramian(T_other)
    cases = {}
    for kind, ch in picked.items():
        cols, vals, mask = ch[:3]
        epi = {}
        if kind == "regular":
            epi = (dict(reg_vec=reg, deg=mask.sum(dim=1).to(torch.float32))
                   if family == "als" else
                   dict(G_global=G_global, reg=FAMILY_REG))
        cases[kind] = ((rows, cols, vals, mask, n), mode, epi)
    return cases


def _check_gram(torch, cases, label: str, card: str):
    """K4 (uncounted launches) against its plain version on each case:
    within the Gram tolerance of the plain version in float64, the same
    bits in two calls, its distance to the float32 plain version and that
    one's own to float64 printed; its time with the stream held, the plain
    version's and the library's (the gather and ``torch.bmm`` / ``einsum``
    of the plain version, no epilogue) and the bound of this chunk's work
    (``gram_work``: distinct rows read once)."""
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.experiments.gram_times import gram_scale, gram_work
    from cu2rec_torch.ops import cuda_gram as cg

    def plain(args, mode, epi, dtype=torch.float32):
        rows, idx, vals, mask, n = args
        mode = {k: (v.to(dtype) if torch.is_tensor(v) else v)
                for k, v in mode.items()}
        G, rhs = cg.gram_rhs_reference(rows.to(dtype), idx, vals.to(dtype),
                                       mask, n, **mode)
        if "reg_vec" in epi:
            G = cg.add_ridge(G, epi["reg_vec"].to(dtype), epi["deg"].to(
                dtype))
        if "G_global" in epi:
            G = cg.add_global(G, epi["G_global"].to(dtype), epi["reg"])
        return G, rhs

    def excess(got, want, scale):
        """(max |got − want|, max of |got − want| − rtol·scale)."""
        out = (0.0, float("-inf"))
        for g, w, sc in zip(got, want, scale):
            d = (g.to(w.dtype) - w).abs()
            out = (max(out[0], float(d.max())),
                   max(out[1], float((d - GRAM_RTOL * sc).max())))
        return out

    out = {}
    for kind, (args, mode, epi) in cases.items():
        kw = {**mode, **epi}
        got = cg._launch(*args, **kw)
        again = cg._launch(*args, **kw)
        want = plain(args, mode, epi)
        exact = plain(args, mode, epi, torch.float64)
        SG, Sr = gram_scale(*args, **mode)
        if "reg_vec" in epi:
            SG = cg.add_ridge(SG, epi["reg_vec"], epi["deg"])
        if "G_global" in epi:
            SG = cg.add_global(SG, epi["G_global"].abs(), epi["reg"])
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"gather_gram {label} {kind}: two calls differ")
        err, _ = excess(got, want, (SG, Sr))
        err64, past = excess(got, exact, (SG, Sr))
        _, plain_past = excess(want, exact, (SG, Sr))
        require(past <= GRAM_ATOL and all(
            bool(torch.isfinite(t).all()) for t in got),
            f"gather_gram {label} {kind} disagrees with its plain version "
            f"in float64: max abs err {err64:.3e}, {past:.3e} past "
            f"{GRAM_RTOL:g} of the sum's scale")
        del exact
        rows, idx, vals, mask, n = args
        live = int(mask.sum())
        distinct = int(torch.unique(idx[mask]).numel())
        B, D = vals.shape
        n_bytes, n_ops = gram_work(n, B, B * D, live, distinct,
                                      ials="alpha" in mode,
                                      epilogue=bool(epi))
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        t = {"ms": time_ms(lambda: cg._launch(*args, **kw), [()], reps=5,
                           hold=True),
             "plain_ms": time_ms(lambda: plain(args, mode, epi), [()],
                                 reps=3),
             "library_ms": time_ms(
                 lambda: cg.gram_rhs_reference(*args, **mode), [()],
                 reps=3)}
        del got, again, want, SG, Sr
        out[kind] = dict(t, B=B, D=D, n=n, live=live, distinct=distinct,
                         max_abs_err=err, max_abs_err_float64=err64,
                         plain_past_float64=plain_past, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=n_bytes, flops=n_ops)
        log(f"[gram] {label} {kind} chunk B={B} D={D} n={n} ({live} live "
            f"slots, {distinct} distinct rows): K4 {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library (gather + bmm/einsum) "
            f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.2f} GFLOP),"
            f" max abs err {err64:.3e} from the plain version in float64 "
            f"(within rtol {GRAM_RTOL:g} of |X|ᵀ|X| + atol {GRAM_ATOL:g}; "
            f"{past:.2e} past the rtol), {err:.3e} from it in float32 (that "
            f"one {plain_past:.2e} past the rtol from float64), the same "
            f"bits twice; {card}")
    torch.cuda.empty_cache()
    return out


def _check_systems(torch, pm, item_chunks, mu: float, card: str):
    """The item half sweep's systems of its largest regular chunk and of
    one heavy chunk, assembled as the sweep assembles them: K1's θ (an
    uncounted launch) against its plain version, and K1's time on the
    largest regular chunk."""
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.ops import als, cuda_linalg as cl

    kernel = cl.kernel_for(F + 1)
    reg = als.reg_vector(FAMILY_REG, FAMILY_REG, F, pm.T_u.device)
    mu32 = torch.tensor(mu, dtype=torch.float32, device=pm.T_u.device)
    regs, heavies = als.split_chunks(item_chunks)
    cols, vals, mask, _rows = max(regs, key=lambda ch: ch[0].shape[0])
    deg = mask.sum(dim=1).to(torch.float32)[:, None]
    systems = {"regular": als.bucket_system(pm.T_u, cols, vals, mask, mu32,
                                            reg, deg)}
    require(heavies, "the item half sweep has no heavy chunk")
    h = heavies[0]
    systems["heavy"] = als.heavy_system(pm.T_u, *h[:3], mu32, reg, *h[4:7])
    out = {}
    for name, (G, rhs) in systems.items():
        got = cl._launch(G.contiguous(), rhs.contiguous(), kernel)
        want = cl.ridge_solve_reference(G, rhs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        require(torch.allclose(got, want, rtol=RTOL, atol=ATOL)
                and bool(torch.isfinite(got).all()),
                f"K1 on the item sweep's {name} chunk disagrees with its "
                f"plain version: {err}")
        out[name] = {"B": G.shape[0], "N": G.shape[-1], "max_abs_err": err}
    G, rhs = (x.contiguous() for x in systems["regular"])
    out["regular"]["ms"] = time_ms(lambda: cl._launch(G, rhs, kernel),
                                   [()], reps=10, hold=True)
    log(f"[als] K1 on the item sweep's systems: largest regular chunk "
        f"B={out['regular']['B']} N={out['regular']['N']} "
        f"{out['regular']['ms']:.4f} ms, max_abs_err "
        f"{out['regular']['max_abs_err']:.3e}; heavy chunk B="
        f"{out['heavy']['B']}, max_abs_err {out['heavy']['max_abs_err']:.3e}"
        f" (rtol {RTOL}, atol {ATOL}) on {card}")
    return out


def _gram_entry(measured, launches: int, registers) -> dict:
    """K4's record of the ``{"kernels": [...]}`` line: its times on the ALS
    item sweep's largest regular chunk (the heavy chunk's and the other
    cases' beside them), the TPU code whose semantics it takes, and its
    launches on the main paths."""
    cases = {fam: measured[fam]["gram"] for fam in ("als", "ials")}
    reg = cases["als"]["items"]["regular"]
    sites = [_tpu_kernel_site("ops/als.py", "def _solve_bucket_weighted"),
             _tpu_kernel_site("ops/als.py", "def _solve_heavy"),
             _tpu_kernel_site("ops/ials.py", "def _solve_ials_bucket"),
             _tpu_kernel_site("ops/ials.py", "def _solve_ials_heavy")]
    return {"name": "gather_gram", "route": "cuda",
            "source": "cu2rec_torch/csrc/gather_gram.cu", "replaces": None,
            "semantics": " ".join(sites) + " (the chunk programs' gather "
            "and einsums)", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for fam in cases.values()
                               for side in fam.values()
                               for c in side.values()),
            "ms": reg["ms"], "plain_ms": reg["plain_ms"],
            "bound_ms": reg["bound_ms"], "bound_by": reg["bound_by"],
            "library_ms": reg["library_ms"],
            "shape": {k: reg[k] for k in ("B", "D", "n", "live", "distinct")},
            "heavy": cases["als"]["items"].get("heavy"), "cases": cases,
            "registers": registers}


def _profile_sweep(torch, pm, user_chunks, item_chunks, mu: float,
                   card: str):
    """One ALS sweep (both half sweeps) under torch.profiler, after one
    unprofiled: the card's busy time, K1's share of it and the top device
    operations."""
    from cu2rec_torch.ops.als import als_half_sweep

    def run():
        T_u = als_half_sweep(pm.T_u, pm.T_i, user_chunks, mu, FAMILY_REG,
                             FAMILY_REG, F)
        als_half_sweep(pm.T_i, T_u, item_chunks, mu, FAMILY_REG,
                       FAMILY_REG, F)
        torch.cuda.synchronize()

    run()
    prof, host_s = _profiled(torch, run, lambda: _new_profile(torch))
    busy_s, ops = _device_breakdown(torch, prof, top=10_000)
    k1_ms = sum(ms for k, ms, _n in ops if "ridge" in k)
    k1_n = sum(n for k, _ms, n in ops if "ridge" in k)
    k4_ms = sum(ms for k, ms, _n in ops if "gather_gram" in k)
    k4_n = sum(n for k, _ms, n in ops if "gather_gram_sums" in k)
    # The sweep's bound: each padded slot's design row (N = F + 1 floats)
    # gathered once, and its Gram and rhs products at the float32 peak:
    # the full N × (N + 1) products a slot, as bmm computes them, and the
    # lower triangle and rhs, N(N + 1)/2 + N, which is all K4 needs.
    N = F + 1
    slots = sum(ch[1].numel() for ch in (*user_chunks, *item_chunks))
    n_bytes, n_ops = 4 * N * slots, 2 * slots * N * (N + 1)
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    tri_ms, tri_by = _bound(n_bytes, 2 * slots * (N * (N + 1) // 2 + N))
    busy_ms = busy_s * 1e3
    log(f"[als] one sweep under the profiler: {host_s * 1e3:.1f} ms host, "
        f"device busy {busy_ms:.3f} ms; K4 {k4_ms:.3f} ms in {k4_n} "
        f"launches ({k4_ms / busy_ms:.1%}), K1 {k1_ms:.3f} ms in {k1_n} "
        f"launches ({k1_ms / busy_ms:.1%} of the device time) "
        f"({len(user_chunks)} user and {len(item_chunks)} item chunks, "
        f"{slots} padded slots); the sweep's bound {bound_ms:.3f} ms "
        f"({bound_by}: {n_ops / 1e12:.3f} TFLOP full Grams, "
        f"{n_bytes / 1e9:.2f} GB), {tri_ms:.3f} ms counting the triangle "
        f"({tri_by}) on {card}; top: " + "; ".join(
            f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in ops[:8]))
    return {"busy_ms": busy_ms, "k1_ms": k1_ms, "k4_ms": k4_ms,
            "host_ms": host_s * 1e3, "slots": slots, "bound_ms": bound_ms,
            "bound_by": bound_by, "triangle_bound_ms": tri_ms}


def _als_run(torch, dev, seed: int, card: str):
    from cu2rec_torch.ops import cuda_gram, cuda_linalg, cuda_loss
    from cu2rec_torch.ops.packed import pack
    from cu2rec_torch.train.als import sweep_chunks, train_als
    from cu2rec_torch.utils.metrics import MetricsLogger

    t0 = time.perf_counter()
    train_csr, test_csr, mu, mean_rmse = _explicit_family_data(seed)
    deg = np.bincount(train_csr.indices, minlength=I)
    heavy = int((deg > HEAVY_DEGREE).sum())
    log(f"[als] planted data: {train_csr.nnz} train and {test_csr.nnz} "
        f"test ratings ({time.perf_counter() - t0:.1f} s); {heavy} items "
        f"of degree > {HEAVY_DEGREE} (top {int(deg.max())}); global-mean "
        f"test RMSE {mean_rmse:.6f}")
    require(heavy >= MIN_HEAVY, f"{heavy} heavy items, want >= {MIN_HEAVY}")
    logger = MetricsLogger(verbose=False)
    cuda_linalg.LAUNCHES = cuda_gram.LAUNCHES = 0
    cuda_loss.LAUNCHES.clear()
    t0 = time.perf_counter()
    model, _losses = train_als(train_csr, test_csr, _family_cfg(seed), mu,
                               logger=logger, device=dev)
    wall = time.perf_counter() - t0
    launches = {"ridge_cholesky": cuda_linalg.LAUNCHES,
                "eval_error": cuda_loss.LAUNCHES.total(),
                "gather_gram": cuda_gram.LAUNCHES}
    require(all(launches.values()), f"train_als launched {launches}")
    recs = [r for r in logger.history if r["event"] == "eval"]
    _gate_als([r["test_rmse"] for r in recs], mean_rmse)
    for r in recs:
        log(f"[als] sweep {r['iteration']}: user half sweep "
            f"{r['half_sweep_ms'][0]:.3f} ms, item half sweep "
            f"{r['half_sweep_ms'][1]:.3f} ms (CUDA events); train RMSE "
            f"{r['train_rmse']:.6f}, test RMSE {r['test_rmse']:.6f}")
    log(f"[als] train_als: {wall:.1f} s wall with set-up; launches "
        f"{launches}; on {card}")
    pm = pack(model)
    user_chunks, item_chunks = sweep_chunks(train_csr, F, dev)
    gram = {side: _check_gram(torch, _gram_cases(torch, chunks, T, "als",
                                                 mu), f"ALS {side}", card)
            for side, chunks, T in (("users", user_chunks, pm.T_i),
                                    ("items", item_chunks, pm.T_u))}
    require("heavy" in gram["items"], "the item half sweep has no heavy "
            "chunk")
    # iALS's planted data has no item above the heavy edge: K4's iALS mode
    # is held on this heavy chunk, over the trained user factors.
    ials_heavy = _gram_cases(torch, item_chunks, pm.T_u[:, :F],
                             "ials")["heavy"]
    gram["items, iALS mode"] = _check_gram(torch, {"heavy": ials_heavy},
                                           "iALS mode, ALS items", card)
    systems = _check_systems(torch, pm, item_chunks, mu, card)
    profile = _profile_sweep(torch, pm, user_chunks, item_chunks, mu, card)
    del model, pm, user_chunks, item_chunks
    torch.cuda.empty_cache()
    return launches, {"half_sweep_ms": [r["half_sweep_ms"] for r in recs],
                      "test_rmse": [r["test_rmse"] for r in recs],
                      "mean_rmse": mean_rmse, "heavy_items": heavy,
                      "gram": gram, "systems": systems, "profile": profile}


def _ials_run(torch, dev, seed: int, card: str):
    from cu2rec_torch.ops import cuda_gram, cuda_linalg
    from cu2rec_torch.train.als import sweep_chunks
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.utils.metrics import MetricsLogger

    t0 = time.perf_counter()
    train_csr, test_csr, oracle = _implicit_on_card(
        torch, U, I, IMPLICIT_DRAWS, F, seed, dev)
    log(f"[ials] implicit planted data built on the card: {train_csr.nnz} "
        f"train and {test_csr.nnz} test pairs of {IMPLICIT_DRAWS} draws "
        f"({time.perf_counter() - t0:.1f} s); oracle AUC {oracle:.4f}")
    logger = MetricsLogger(verbose=False)
    cuda_linalg.LAUNCHES = cuda_gram.LAUNCHES = 0
    t0 = time.perf_counter()
    model, _ = train_ials(train_csr, test_csr, _family_cfg(seed),
                          alpha=ALPHA, logger=logger, device=dev)
    wall = time.perf_counter() - t0
    launches = {"ridge_cholesky": cuda_linalg.LAUNCHES,
                "gather_gram": cuda_gram.LAUNCHES}
    require(all(launches.values()), f"train_ials launched {launches}")
    rows = _history_rows(logger)
    _gate_ials(rows, I)
    for r, (it, auc, rec, ndcg) in zip(
            [r for r in logger.history if r["event"] == "eval"], rows):
        log(f"[ials] sweep {it}: user half sweep {r['half_sweep_ms'][0]:.3f}"
            f" ms, item half sweep {r['half_sweep_ms'][1]:.3f} ms (CUDA "
            f"events); AUC {auc:.4f}, recall@10 {rec:.4f}, ndcg@10 "
            f"{ndcg:.4f}")
    log(f"[ials] train_ials: {wall:.1f} s wall; launches {launches}; "
        f"oracle AUC {oracle:.4f}; on {card}")
    user_chunks, item_chunks = sweep_chunks(train_csr, F, dev)
    gram = {side: _check_gram(torch, _gram_cases(torch, chunks, T, "ials"),
                              f"iALS {side}", card)
            for side, chunks, T in (("users", user_chunks, model.Q),
                                    ("items", item_chunks, model.P))}
    del model, user_chunks, item_chunks
    torch.cuda.empty_cache()
    return launches, (train_csr, test_csr), {
        "half_sweep_ms": [r["half_sweep_ms"] for r in logger.history
                          if r["event"] == "eval"],
        "metrics": rows, "oracle_auc": oracle, "gram": gram}


def _bpr_run(torch, dev, seed: int, csrs, card: str):
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_bpr
    from cu2rec_torch.ops.bpr import bpr_draws, bpr_run_steps, bpr_step
    from cu2rec_torch.ops.packed import pack
    from cu2rec_torch.ops.sgd import Hyper, prng_key
    from cu2rec_torch.train.bpr import train_bpr
    from cu2rec_torch.utils.metrics import MetricsLogger

    train_csr, test_csr = csrs
    hp = Hyper(BPR_LR, BPR_REG, BPR_REG, BPR_REG, BPR_REG)
    rng = np.random.default_rng(seed)
    tables = {"p": rng.normal(0, 0.1, (U, F)), "q": rng.normal(0, 0.1, (I, F)),
              "user_bias": np.zeros(U), "item_bias": np.zeros(I),
              "global_bias": [0.0]}
    t0 = time.perf_counter()
    pms = {d: pack(model_from_numpy(tables, d)) for d in (dev, "cpu")}
    devs = {d: to_device(train_csr, d, item_major=True) for d in pms}
    worst = 0.0
    for it in range(3):
        a, b = (bpr_draws(devs[d], prng_key(seed), it) for d in pms)
        for name in a._fields:
            require(torch.equal(getattr(a, name).cpu(), getattr(b, name)),
                    f"bpr step {it}: the card's {name} differs from the CPU's")
        for d in pms:
            pms[d] = bpr_step(pms[d], devs[d], hp, prng_key(seed), it)
        for side in ("T_u", "T_i"):
            err = float((getattr(pms[dev], side).cpu()
                         - getattr(pms["cpu"], side)).abs().max())
            worst = max(worst, err)
            require(err <= STEP_ATOL, f"bpr step {it}: {side} differs from "
                    f"the CPU's by {err}")
    log(f"[bpr] 3 steps on the card (K6) and on the CPU (plain): the same "
        f"sampled ids, tables within {worst:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    pm, dr = pms[dev], devs[dev]
    del pms, devs
    bpr_run_steps(pm, dr, hp, prng_key(seed), 3, 3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cuda_bpr.LAUNCHES = 0
    start.record()
    bpr_run_steps(pm, dr, hp, prng_key(seed), 6, 50)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 50
    k6_a_step = cuda_bpr.LAUNCHES / 50
    require(k6_a_step == 1, f"bpr: {k6_a_step} K6 launches a step, not 1")

    def run():
        bpr_run_steps(pm, dr, hp, prng_key(seed), 56, 20)
        torch.cuda.synchronize()

    prof, host_s = _profiled(torch, run, lambda: _new_profile(torch))
    busy_s, ops = _device_breakdown(torch, prof, top=10_000)
    busy_ms, launches = busy_s * 1e3 / 20, sum(n for _k, _ms, n in ops) / 20
    logger = MetricsLogger(verbose=False)
    t0 = time.perf_counter()
    cfg = _family_cfg(seed, total_iterations=BPR_ITERATIONS,
                      check_error=BPR_CHECK, learning_rate=BPR_LR,
                      P_reg=BPR_REG, Q_reg=BPR_REG, user_bias_reg=BPR_REG,
                      item_bias_reg=BPR_REG)
    k6 = _k6_entry(torch, dev, dr, pm, hp, seed, train_csr, worst)
    cuda_bpr.LAUNCHES = 0
    train_bpr(train_csr, test_csr, cfg, logger=logger, device=dev)
    train_launches = cuda_bpr.LAUNCHES
    require(train_launches == BPR_ITERATIONS, f"train_bpr launched K6 "
            f"{train_launches} times in {BPR_ITERATIONS} iterations")
    wall = time.perf_counter() - t0
    rows = _history_rows(logger)
    _gate_bpr(rows)
    log(f"[bpr] a step at U={U} I={I} F={F}: {step_ms:.4f} ms (CUDA events "
        f"over 50 steps, {k6_a_step:g} K6 launch a step), "
        f"{U / step_ms * 1e3:.4g} user updates/s; under the "
        f"profiler {busy_ms:.4f} ms of device time a step "
        f"({busy_ms / step_ms:.1%} of the event time) in {launches:.0f} "
        f"kernels, {host_s * 1e3 / 20:.4f} ms of host time a step; train_bpr "
        f"{BPR_ITERATIONS} iterations {wall:.1f} s wall with evals, "
        f"{train_launches} K6 launches; "
        + "; ".join(f"iteration {it}: AUC {auc:.4f}, recall@10 {rec:.4f}, "
                    f"ndcg@10 {ndcg:.4f}" for it, auc, rec, ndcg in rows)
        + f" on {card}")
    return {"step_ms": step_ms, "busy_ms": busy_ms, "kernels": launches,
            "k6_launches_a_step": k6_a_step, "k6": k6,
            "k6_train_launches": train_launches, "metrics": rows,
            "max_abs_err": worst}


def _k6_entry(torch, dev, dr, pm, hp, seed: int, train_csr, err: float):
    """K6's record of the ``{"kernels": [...]}`` line: a step with the
    stream held (50 steps enqueued), the plain step on the card, and the
    bound of ``benchmark/counts/bpr.py``'s bytes, at the phase's shape
    (F = 100, float32) and, under ``cases``, at the BPR cell's width
    (F = 50) on the same ratings.  ``launches`` is filled in by ``main``."""
    from benchmark.counts.bpr import step_bytes, step_ops
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops.bpr import bpr_step, bpr_step_reference
    from cu2rec_torch.ops.packed import pack
    from cu2rec_torch.ops.sgd import prng_key

    users_with = int((dr.indptr[1:] > dr.indptr[:-1]).sum())
    items_with = int((dr.it_indptr[1:] > dr.it_indptr[:-1]).sum())
    rng = np.random.default_rng(seed + 1)
    narrow = pack(model_from_numpy(
        {"p": rng.normal(0, 0.1, (U, 50)), "q": rng.normal(0, 0.1, (I, 50)),
         "user_bias": np.zeros(U), "item_bias": np.zeros(I),
         "global_bias": [0.0]}, dev))
    cases = {}
    for label, m in (("F100", pm), ("F50", narrow)):
        ms = time_ms(lambda: bpr_step(m, dr, hp, prng_key(seed), 7), [()],
                     reps=50, hold=True)
        plain_ms = time_ms(lambda: bpr_step_reference(
            m, dr, hp, prng_key(seed), 7), [()], reps=3)
        elem = m.T_u.element_size()
        n_bytes = step_bytes(U, I, m.width, users_with, items_with, elem)
        n_ops = step_ops(m.n_factors, users_with, I)
        bound_ms, bound_by = _bound(n_bytes, n_ops)
        cases[label] = {"ms": ms, "plain_ms": plain_ms, "n_bytes": n_bytes,
                        "n_ops": n_ops, "bound_ms": bound_ms,
                        "bound_by": bound_by, "F": m.n_factors,
                        "W": m.width}
        log(f"[bpr] K6 at U={U} I={I} F={m.n_factors} (W={m.width}, "
            f"float32): {ms:.4f} ms a step (the stream held), "
            f"{bound_ms / ms:.1%} of its {bound_ms:.4f} ms bound "
            f"({n_bytes / 1e6:.1f} MB); the plain step {plain_ms:.3f} ms")
    del narrow
    head = cases["F100"]
    entry = _entry("bpr_step", _tpu_kernel_site("ops/bpr.py",
                                                "def bpr_step("),
                   err, head["ms"], head["plain_ms"], head["n_bytes"],
                   head["n_ops"], None,
                   {"U": U, "I": I, "F": F, "W": pm.width,
                    "nnz": train_csr.nnz, "dtype": "float32"},
                   semantics="(jnp, with bpr_draws' five streams)")
    entry["cases"] = cases
    return entry


def _family_csvs(seed: int, workdir: Path):
    """ML-100K-shaped planted CSVs: explicit (for ALS) and implicit (for
    iALS and BPR), each split 90/10, through ``write_planted_csv``."""
    import dataclasses

    from cu2rec_torch.data.synth import (
        generate_planted, generate_planted_implicit, split_arrays,
        write_planted_csv,
    )

    paths = {}
    explicit = generate_planted(*ML100K, seed=seed)
    implicit, _oracle = generate_planted_implicit(*ML100K, seed=seed)
    for kind, d in (("explicit", explicit), ("implicit", implicit)):
        sides = split_arrays(d.users, d.items, d.ratings, 0.9, seed=seed)
        for name, (u, i, r) in zip(("train", "test"), sides):
            path = workdir / f"{kind}_{name}.csv"
            write_planted_csv(dataclasses.replace(d, users=u, items=i,
                                                  ratings=r), str(path))
            paths[kind, name] = str(path)
    return paths


def _entry_points(seed: int, workdir: Path, card: str, device: str = "cuda"):
    """``mf --algo als|ials|bpr`` on the planted CSVs: exit 0, every metric
    line parses, the five component CSVs, K1 and K4 (ALS, iALS) and K0b
    (ALS) launched, and K6 once an iteration in BPR and never in ALS or
    iALS.  Returns {algo: {kernel: launches}}."""
    from cu2rec_torch.cli import mf
    from cu2rec_torch.ops import cuda_bpr, cuda_gram, cuda_linalg, cuda_loss

    paths = _family_csvs(seed, workdir)
    # cur total F lr seed P_reg Q_reg ub_reg ib_reg n_threads check_error
    # patience lr_decay
    configs = {
        "als": f"0 {SWEEPS} {F} 0.05 {seed} {FAMILY_REG} {FAMILY_REG} "
               f"{FAMILY_REG} {FAMILY_REG} 32 1 2 0.2\n",
        "ials": f"0 {SWEEPS} {F} 0.05 {seed} {FAMILY_REG} {FAMILY_REG} "
                f"{FAMILY_REG} {FAMILY_REG} 32 1 2 0.2\n",
        "bpr": f"0 200 {F} {BPR_LR} {seed} {BPR_REG} {BPR_REG} {BPR_REG} "
               f"{BPR_REG} 32 100 2 0.2\n"}
    launches = {}
    for algo, cfg_text in configs.items():
        kind = "explicit" if algo == "als" else "implicit"
        cfg = workdir / f"{algo}.cfg"
        cfg.write_text(cfg_text)
        out = workdir / f"out_{algo}"
        cuda_linalg.LAUNCHES = cuda_gram.LAUNCHES = cuda_bpr.LAUNCHES = 0
        cuda_loss.LAUNCHES.clear()
        t0 = time.perf_counter()
        text = _capture(mf.main, ["-c", str(cfg), paths[kind, "train"],
                                  paths[kind, "test"], "--algo", algo,
                                  "--outdir", str(out), "--device", device])
        wall = time.perf_counter() - t0
        launches[algo] = {"ridge_cholesky": cuda_linalg.LAUNCHES,
                          "eval_error": cuda_loss.LAUNCHES.total(),
                          "gather_gram": cuda_gram.LAUNCHES,
                          "bpr_step": cuda_bpr.LAUNCHES}
        if algo == "als":
            metrics = [METRIC_LINE.match(ln) for ln in text.splitlines()
                       if ln.startswith(("TRAIN:", "TEST:"))]
            require(len(metrics) == 2 * SWEEPS and all(metrics),
                    "an ALS TRAIN/TEST line does not parse")
            last = metrics[-1][0]
        else:
            rows = _implicit_metrics(text)
            last = rows[-1]
        for comp in ("p", "q", "user_bias", "item_bias", "global_bias"):
            require((out / f"{kind}_train_f{F}_{comp}.csv").exists(),
                    f"mf --algo {algo}: {comp} CSV missing")
        want = {"als": ("ridge_cholesky", "eval_error", "gather_gram"),
                "ials": ("ridge_cholesky", "gather_gram"), "bpr": ()}[algo]
        require(device == "cpu" or all(launches[algo][k] for k in want),
                f"mf --algo {algo} launched {launches[algo]}")
        # K6 once an iteration of BPR's single-device card step, else never.
        k6 = 200 if algo == "bpr" and device != "cpu" else 0
        require(launches[algo]["bpr_step"] == k6, f"mf --algo {algo} "
                f"launched K6 {launches[algo]['bpr_step']} times, not {k6}")
        log(f"[mf] --algo {algo} on {ML100K[0]} x {ML100K[1]}, "
            f"{ML100K[2]} planted draws: {wall:.1f} s wall, launches "
            f"{launches[algo]}; last metrics: {last} on {card}")
    return launches


def phase_families(torch, dev, seed: int, card: str):
    """Phase 7: ALS, iALS and BPR at the headline widths through their
    trainers, then ``mf --algo als|ials|bpr``.  Returns the launch counts
    of K1, K0b, K4 and K6 over the phase's main paths, and what it
    measured."""
    t0 = time.perf_counter()
    launches = {"ridge_cholesky": 0, "eval_error": 0, "gather_gram": 0,
                "bpr_step": 0}
    als_launches, als = _als_run(torch, dev, seed, card)
    ials_launches, csrs, ials = _ials_run(torch, dev, seed, card)
    bpr = _bpr_run(torch, dev, seed, csrs, card)
    del csrs
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        cli = _entry_points(seed, Path(tmp), card)
    launches["bpr_step"] = bpr["k6_train_launches"]
    for counts in (als_launches, ials_launches, *cli.values()):
        for k, n in counts.items():
            launches[k] += n
    wall = time.perf_counter() - t0
    log(f"[families] phase wall {wall:.1f} s; K1, K0b, K4 and K6 launches "
        f"over its main paths {launches}")
    return launches, {"als": als, "ials": ials, "bpr": bpr, "mf": cli,
                      "wall_s": wall}


# -- phase 8: the preprocessing journey (synth → map_items → split → mf →
# evaluate → convert_to_np) ------------------------------------------------

# ``synth --preset ml20m``: 138,000 users x 27,000 items x 20,000,000
# planted ratings (rank 20); mf trains F=100 for 100 iterations on the 90%
# split, evaluating every 50.
PIPE_PRESET, PIPE_ITERATIONS, PIPE_CHECK, PIPE_TEST_RATIO = \
    "ml20m", 100, 50, 0.1
# evaluate from the checkpoint against mf's final TEST line (printed with 6
# decimals); from the component CSVs (6 decimals a value) against that.
PIPE_CKPT_TOL, PIPE_CSV_TOL = 1e-6, 1e-4
# evaluate --ranking over the first 10,000 test users against a float64
# NumPy top-10 from the checkpoint: a near-tie at the 10th place may swap
# an item between float32 and float64, which moves the mean by at most one
# user's recall or NDCG.
PIPE_RANKING_USERS, PIPE_TOP_K = 10_000, 10
# The exported Q (6 decimals, read back as float32) against the checkpoint's:
# half a unit of the 6th decimal, plus the float32 rounding of the decimal.
PIPE_Q_TOL = 5e-7


def _timed(steps: dict, name: str, main, args):
    t0 = time.perf_counter()
    text = _capture(main, args)
    steps[name] = time.perf_counter() - t0
    return text


def _eval_summary(text: str):
    """(the TEST line's (MAE, RMSE), the JSON summary) of an evaluate run."""
    m = METRIC_LINE.match(text.splitlines()[0])
    require(m and m[1] == "TEST", f"evaluate printed {text[:200]!r}")
    return (float(m[3]), float(m[4])), json.loads(text.splitlines()[-1])


def _same_ratings(a, b) -> bool:
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               and getattr(a, f).dtype == getattr(b, f).dtype
               for f in ("users", "items", "ratings")) and \
        (a.n_users, a.n_items, a.global_bias) == \
        (b.n_users, b.n_items, b.global_bias)


def _ranking_reference(ck: Path, train, test, max_users: int, k: int,
                       block: int = 512):
    """(recall@k, NDCG@k, users) of the checkpoint's model over the first
    ``max_users`` users with test ratings, in float64 NumPy: each user's
    top k of the items unrated in train, scored against the test items
    (the definitions of ``ops/topk.py``)."""
    with np.load(ck) as z:
        P, Q = z["p"].astype(np.float64), z["q"].astype(np.float64)
        ub = z["user_bias"].astype(np.float64)
        ib = z["item_bias"].astype(np.float64)
        mu = float(z["global_bias"].reshape(-1)[0])
    users = np.nonzero(np.diff(test.indptr) > 0)[0][:max_users]
    disc = 1.0 / np.log2(np.arange(k) + 2.0)
    recall = ndcg = 0.0
    for b0 in range(0, len(users), block):
        us = users[b0:b0 + block]
        scores = P[us] @ Q.T + ib[None, :] + ub[us, None] + mu
        for row, u in enumerate(us):
            scores[row, train.indices[train.indptr[u]:
                                      train.indptr[u + 1]]] = -np.inf
        top = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        top = np.take_along_axis(top, np.argsort(
            -np.take_along_axis(scores, top, 1), axis=1, kind="stable"), 1)
        for row, u in enumerate(us):
            rel = test.indices[test.indptr[u]:test.indptr[u + 1]]
            hit = np.isin(top[row], rel)
            recall += np.isin(rel, top[row]).sum() / len(rel)
            ndcg += float(hit @ disc) / disc[:min(len(rel), k)].sum()
    return recall / len(users), ndcg / len(users), len(users)


def phase_pipeline(seed: int, workdir: Path, card: str,
                   device: str = "cuda"):
    """Phase 8: the journey a user runs before and after training, through
    the CLIs' ``main``s at ML-20M scale.  Returns the K0a and K0b launches
    of its ``mf`` and ``evaluate`` runs and what it measured."""
    from cu2rec_torch.cli import (
        convert_to_np, evaluate, map_items, mf, split, synth,
    )
    from cu2rec_torch.data import native
    from cu2rec_torch.data.csr import build_csr
    from cu2rec_torch.data.ratings import read_ratings_csv
    from cu2rec_torch.ops import cuda_loss, cuda_sgd

    t_phase = time.perf_counter()
    steps = {}
    raw = workdir / "raw.csv"
    _timed(steps, "synth", synth.main, [str(raw), "--preset", PIPE_PRESET,
                                        "--seed", str(seed)])
    meta = json.loads(Path(f"{raw}.meta.json").read_text())
    _timed(steps, "map_items", map_items.main, [str(raw)])
    mapped = workdir / "raw_mapped.csv"
    require(mapped.stat().st_size > split.FAST_BYTES
            or PIPE_PRESET != "ml20m",
            f"{mapped} is {mapped.stat().st_size} bytes: split would not "
            f"take its fast path")
    _timed(steps, "split", split.main, [str(mapped), str(PIPE_TEST_RATIO),
                                        "-s", str(seed)])
    train = str(workdir / "raw_mapped_train.csv")
    test = str(workdir / "raw_mapped_test.csv")

    cfg = workdir / "pipeline.cfg"
    # cur total F lr seed P_reg Q_reg ub_reg ib_reg n_threads check_error
    # patience lr_decay
    cfg.write_text(f"0 {PIPE_ITERATIONS} {F} 0.05 {seed} 0.02 0.02 0.02 "
                   f"0.02 32 {PIPE_CHECK} 2 0.2\n")
    out = workdir / "out"
    ck, jsonl = workdir / "model.npz", workdir / "pipeline.jsonl"
    native.CALLS = 0
    cuda_sgd.LAUNCHES.clear()
    cuda_loss.LAUNCHES.clear()
    t_start = time.time()
    text = _timed(steps, "mf", mf.main, [
        "-c", str(cfg), train, test, "--outdir", str(out), "--checkpoint",
        str(ck), "--jsonl", str(jsonl), "--device", device])
    t_end = time.time()
    native_calls = native.CALLS
    launches = {"sgd_step": cuda_sgd.LAUNCHES.total(),
                "eval_error": cuda_loss.LAUNCHES.total()}
    require(native_calls > 0, "mf made no call into the native library")
    require(device == "cpu" or all(launches.values()),
            f"mf did not launch both kernels: {launches}")
    metrics = [METRIC_LINE.match(ln) for ln in text.splitlines()
               if ln.startswith(("TRAIN:", "TEST:"))]
    require(metrics and all(metrics), "a TRAIN/TEST line does not parse")
    tests = [(int(m[2]), float(m[3]), float(m[4])) for m in metrics
             if m[1] == "TEST"]
    require([it for it, _, _ in tests] == [1, PIPE_CHECK, PIPE_ITERATIONS],
            f"eval points {tests}")
    require(tests[-1][2] < tests[0][2],
            f"test RMSE {tests[-1][2]} is not below iteration 1's "
            f"{tests[0][2]}")
    recs = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
    t_eval1 = next(r["ts"] for r in recs if r["event"] == "eval")
    t_loop = next(r["ts"] for r in recs if r["event"] == "time")
    base = out / f"raw_mapped_train_f{F}_"
    csv_s, ckpt_s = _export_split(t_loop, out, base.name, ck)
    split_s = {"set-up and first eval": t_eval1 - t_start,
               "iterations": t_loop - t_eval1, "export": t_end - t_loop,
               "export CSVs": csv_s, "export checkpoint": ckpt_s}

    # evaluate: from the checkpoint, from the five CSVs, with --ranking.
    parts = ["-p", f"{base}p.csv", "-q", f"{base}q.csv", "-u",
             f"{base}user_bias.csv", "-i", f"{base}item_bias.csv", "-g",
             f"{base}global_bias.csv"]
    cuda_loss.LAUNCHES.clear()
    (mae, rmse), s_ck = _eval_summary(_timed(
        steps, "evaluate", evaluate.main,
        ["--checkpoint", str(ck), test, "--device", device]))
    want_mae, want_rmse = tests[-1][1], tests[-1][2]
    ck_err = max(abs(s_ck["test_rmse"] - want_rmse),
                 abs(s_ck["test_mae"] - want_mae))
    require(ck_err <= PIPE_CKPT_TOL,
            f"evaluate --checkpoint gives RMSE {s_ck['test_rmse']}, MAE "
            f"{s_ck['test_mae']}; mf's final TEST line {want_rmse}, "
            f"{want_mae}")
    _, s_csv = _eval_summary(_timed(steps, "evaluate (CSVs)", evaluate.main,
                                    parts + [test, "--device", device]))
    csv_err = max(abs(s_csv["test_rmse"] - s_ck["test_rmse"]),
                  abs(s_csv["test_mae"] - s_ck["test_mae"]))
    require(csv_err <= PIPE_CSV_TOL,
            f"evaluate on the CSVs is {csv_err} from the checkpoint's")
    _, s_rank = _eval_summary(_timed(
        steps, "evaluate --ranking", evaluate.main,
        ["--checkpoint", str(ck), test, "--ranking", "--train", train,
         "--max-users", str(PIPE_RANKING_USERS), "-k", str(PIPE_TOP_K),
         "--device", device]))
    csrs = [build_csr(read_ratings_csv(p), n_users=meta["users"],
                      n_items=meta["items"]) for p in (train, test)]
    t0 = time.perf_counter()
    ref_recall, ref_ndcg, n_ranked = _ranking_reference(
        ck, *csrs, PIPE_RANKING_USERS, PIPE_TOP_K)
    steps["ranking reference"] = time.perf_counter() - t0
    rank_err = max(abs(s_rank["recall_at_k"] - ref_recall),
                   abs(s_rank["ndcg_at_k"] - ref_ndcg))
    require(rank_err <= 1.0 / n_ranked,
            f"evaluate --ranking gives recall@{PIPE_TOP_K} "
            f"{s_rank['recall_at_k']}, NDCG {s_rank['ndcg_at_k']}; the "
            f"float64 reference {ref_recall}, {ref_ndcg}")
    random_recall = PIPE_TOP_K / meta["items"]
    eval_launches = cuda_loss.LAUNCHES.total()
    require(device == "cpu" or eval_launches >= 3,
            f"evaluate launched K0b {eval_launches} times in 3 runs")
    launches["eval_error"] += eval_launches

    # convert_to_np on the exported Q, against the checkpoint's.
    _timed(steps, "convert_to_np", convert_to_np.main, [f"{base}q.csv"])
    with np.load(ck) as z:
        q = z["q"]
    npy = np.load(f"{base}q.npy")
    q_err = float(np.abs(npy - q).max())
    half_ulp = float(np.spacing(np.abs(q).max())) / 2
    require(npy.shape == q.shape and q_err <= PIPE_Q_TOL + half_ulp,
            f"the .npy of the exported Q is {q_err} from the checkpoint's")

    # The native reader against its plain version on the test split.
    t0 = time.perf_counter()
    fast = read_ratings_csv(test)
    native_s = time.perf_counter() - t0
    plain = read_ratings_csv(test, use_native=False)
    plain_s = time.perf_counter() - t0 - native_s
    require(_same_ratings(fast, plain),
            "the native reader and its plain version read the test split "
            "differently")
    steps["phase"] = time.perf_counter() - t_phase
    log(f"[pipeline] synth {meta['users']} x {meta['items']} x "
        f"{meta['ratings']} (rank {meta['planted_factors']}); split "
        f"{fast.nnz} test ratings; mf on {card}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in split_s.items())
        + f"; test RMSE {tests[0][2]:.6f} -> {tests[-1][2]:.6f} (floor "
        f"{meta['noise_floor']}); native calls {native_calls}; launches "
        f"{launches}")
    log(f"[pipeline] evaluate: checkpoint RMSE {s_ck['test_rmse']:.7f} MAE "
        f"{s_ck['test_mae']:.7f} ({ck_err:.2e} from mf's line), CSVs "
        f"{csv_err:.2e} from it, recall@10 {s_rank['recall_at_k']:.6f} "
        f"ndcg@10 {s_rank['ndcg_at_k']:.6f} over {n_ranked} users, "
        f"{rank_err:.2e} from the float64 reference (a random 10 items: "
        f"recall {random_recall:.2e}); Q .npy max err {q_err:.2e}; "
        f"read_ratings_csv of the test split native {native_s:.3f} s, "
        f"plain {plain_s:.3f} s, the same arrays")
    log("[pipeline] seconds: " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in steps.items())
        + f" on {card}")
    return launches, {"steps_s": steps, "mf_s": split_s,
                      "native_calls": native_calls,
                      "read_s": {"native": native_s, "plain": plain_s},
                      "test_rmse": s_ck["test_rmse"],
                      "recall_at_k": s_rank["recall_at_k"]}


# -- phase 9: bf16 tables, mean/sum and the client --------------------------

# K0a's variants beyond phase 4's float32 first_wins and twin: (table dtype,
# collision policy).
VARIANTS = (("bfloat16", "first_wins"), ("bfloat16", "twin"),
            ("float32", "mean"), ("bfloat16", "mean"),
            ("float32", "sum"), ("bfloat16", "sum"))
# Under mean and sum an item's bf16 entry is a chain of adds, each rounded
# to bf16: a rounding that the float32 error of one pair's delta flips
# moves the sum by one ulp of the largest magnitude the chain reached, and
# a long chain may meet two such flips.
BF16_CHAIN_ULPS = 2.0
# The power law of the skewed ratings: its top item draws 1/27,000 ** 0.3,
# ML-20M's 4.7% of the ratings.
SKEW_POWER = 0.3
# The trainer runs of the variants that no mf run of this phase drives.
VARIANT_ITERATIONS = 20
CLIENT_CALLS = 10_000


def _bf16_error(torch, got, want, pre, peak=None):
    """(scaled, above, raw): the largest |got − want| over the entries of
    two bf16 tables in bf16 ulps of the entry's operand scale max(|pre|,
    |want|, peak), the number of entries more than one such ulp apart, and
    the largest distance in raw bf16 ulps.  Where an update cancels most
    of the entry, the float32 rounding of its operands is many raw ulps of
    the small result, and one ulp of the operands' scale; ``peak`` is the
    largest magnitude a chain of adds reached on the way."""
    g, w, p = (t.to(torch.float32) for t in (got, want, pre))
    scale = torch.maximum(p.abs(), w.abs())
    if peak is not None:
        scale = torch.maximum(scale, peak)
    scale = scale.clamp(min=2.0 ** -126)
    _, e = torch.frexp(scale)
    ulp = torch.ldexp(torch.ones_like(scale), e - 8)
    err = (g - w).abs() / ulp
    scaled, above = float(err.max()), int((err > 1.0).sum())

    def ordered(t):
        b = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(b >= 0x8000, 0x8000 - b, b)

    raw = int((ordered(got) - ordered(want)).abs().max())
    return scaled, above, raw


def _planted_scatter(torch, fault: str):
    """``ops/packed.py::scatter_add_in_order`` with one fault planted in
    the longest run of a step's pairs: "drop" leaves its last pair out,
    "reverse" adds the run in reverse user order.  What the bf16 gate reads
    for a kernel that went wrong so."""
    from cu2rec_torch.ops.packed import scatter_add_in_order

    def scatter(T, idx, src, peak=None):
        at = torch.nonzero(idx == torch.bincount(idx).argmax())[:, 0]
        if fault == "drop":
            keep = torch.ones_like(idx, dtype=torch.bool)
            keep[at[-1]] = False
            return scatter_add_in_order(T, idx[keep], src[keep], peak)
        order = torch.arange(idx.numel(), device=idx.device)
        order[at] = at.flip(0)
        return scatter_add_in_order(T, idx[order], src[order], peak)

    return scatter


def _planted_readings(torch, pm, dr, collision, seed, got, peak):
    """{fault: the bf16 gate's reading of ``got``'s item table against the
    plain version with that fault planted}."""
    from cu2rec_torch.ops import packed
    from cu2rec_torch.ops.sgd import prng_key

    real = packed.scatter_add_in_order
    readings = {}
    for fault in ("drop", "reverse"):
        packed.scatter_add_in_order = _planted_scatter(torch, fault)
        try:
            bad = packed.packed_step_reference(pm, dr, _hp(), prng_key(seed),
                                               0, collision=collision)
        finally:
            packed.scatter_add_in_order = real
        readings[fault] = _bf16_error(torch, got.T_i, bad.T_i, pm.T_i,
                                      peak)[0]
    return readings


def _check_runs(torch, offsets, users, items, has, n_items: int,
                label: str) -> int:
    """Holds the runs of a mean/sum step (offsets and users, from the card
    or planted) bit for bit against ``torch.sort(items[has], stable=True)``
    and ``torch.bincount``: each item's run start, and the users in item
    order and, within an item, in user order.  Returns the longest run."""
    who = torch.nonzero(has)[:, 0]
    keys = items[who]
    want_users = who[torch.sort(keys, stable=True).indices]
    counts = torch.bincount(keys, minlength=n_items)
    want_offsets = torch.zeros(n_items + 1, dtype=torch.int64,
                               device=keys.device)
    want_offsets[1:] = torch.cumsum(counts, 0)
    require(offsets.shape == want_offsets.shape
            and torch.equal(offsets.long(), want_offsets),
            f"{label}: the run offsets differ from the pairs' counts")
    require(users.shape == want_users.shape
            and torch.equal(users.long(), want_users),
            f"{label}: the users are not in item order and, within each "
            f"run, in user order")
    return int(counts.max()) if counts.numel() else 0


def _planted_runs(torch, offsets, users, fault: str):
    """The runs with one fault planted in the longest run: "swap" swaps its
    first two users, "drop" leaves out its last user (the offsets after it
    moved down by one, as a sort that lost the pair would give them)."""
    run = int(torch.argmax(offsets[1:] - offsets[:-1]))
    s, e = int(offsets[run]), int(offsets[run + 1])
    users, offsets = users.clone(), offsets.clone()
    if fault == "swap":
        users[[s, s + 1]] = users[[s + 1, s]]
        return offsets, users
    offsets[run + 1:] -= 1
    return offsets, torch.cat([users[:e - 1], users[e:]])


def _check_run_order(torch, dr, seed: int, label: str):
    """The runs of a mean/sum step on the card (``collision_runs_cuda``:
    the step's sampling, counting sort and ordering) against the stable
    sort, and the check run again on each planted fault, which it must
    reject.  Returns (pairs, longest run)."""
    from cu2rec_torch.ops.packed import collision_runs
    from cu2rec_torch.ops.sgd import prng_key, sample_items

    offsets, users = collision_runs(dr, prng_key(seed), 7)
    items, _r, has = sample_items(prng_key(seed), 7, dr.indptr, dr.indices,
                                  dr.data)
    longest = _check_runs(torch, offsets, users, items, has, dr.n_items,
                          label)
    for fault in ("swap", "drop"):
        bad = _planted_runs(torch, offsets, users, fault)
        try:
            _check_runs(torch, *bad, items, has, dr.n_items, label)
        except SmokeFailure:
            continue
        raise SmokeFailure(f"{label}: the run-order check passes a planted "
                           f"{fault}")
    log(f"[variants] run order {label}: {users.numel()} pairs, the longest "
        f"run {longest}, offsets and users bit for bit the stable sort's; "
        f"a planted swap and a planted dropped pair rejected")
    return users.numel(), longest


def _dtype_name(dtype) -> str:
    """"float32" for torch.float32 and so on."""
    return str(dtype).removeprefix("torch.")


def _short(kernel: str) -> str:
    """A profiler's kernel name without its return type and namespace."""
    return re.sub(r"^void \(anonymous namespace\)::", "", kernel)[:48]


def _check_variant(torch, pm, dr, dtype: str, collision: str, seed: int):
    """Two steps of one variant, kernel against plain version from the same
    tables: float32 within STEP_ATOL; bf16 within one bf16 ulp of the
    operands' scale, the item side of mean and sum within BF16_CHAIN_ULPS;
    mean/sum the same bits in two calls.  For bf16 mean/sum it also reads
    the gate against the plain version with a fault planted at step 0,
    and requires that the gate rejects a dropped pair under sum (under
    mean the pair's delta is divided by its run's count, and a long run's
    may fall below a bf16 ulp).  Returns the largest absolute
    difference."""
    from cu2rec_torch.ops.packed import packed_step, packed_step_reference
    from cu2rec_torch.ops.sgd import prng_key

    label = f"sgd_step {dtype}/{collision}"
    worst = 0.0
    for it in (0, 3):
        kw = dict(collision=collision)
        got = packed_step(pm, dr, _hp(), prng_key(seed), it, **kw)
        again = packed_step(pm, dr, _hp(), prng_key(seed), it, **kw)
        peak = None
        if dtype == "bfloat16" and collision in ("mean", "sum"):
            peak = torch.zeros(pm.T_i.shape, device=pm.T_i.device)
        want = packed_step_reference(pm, dr, _hp(), prng_key(seed), it,
                                     peak=peak, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, s), getattr(again, s))
                   for s in ("T_u", "T_i"))
        require(same or collision not in ("mean", "sum"),
                f"{label} step {it}: two calls give other bits")
        for side in ("T_u", "T_i"):
            g, w, p = (getattr(x, side) for x in (got, want, pm))
            require(g.dtype == p.dtype, f"{label}: {side} is {g.dtype}")
            err = float((g.float() - w.float()).abs().max())
            worst = max(worst, err)
            if dtype == "float32":
                require(err <= STEP_ATOL, f"{label} step {it}: {side} "
                        f"differs by {err}")
                log(f"[variants] {label} step {it} {side}: max_abs_err "
                    f"{err:.3e}, the same bits twice: {same}")
                continue
            scaled, above, raw = _bf16_error(
                torch, g, w, p, peak if side == "T_i" else None)
            chain = side == "T_i" and peak is not None
            gate = BF16_CHAIN_ULPS if chain else 1.0
            require(scaled <= gate, f"{label} step {it}: {side} differs by "
                    f"{scaled:.3f} bf16 ulps of the operands' scale (gate "
                    f"{gate}; {above} of {g.numel()} entries above 1)")
            planted = ""
            if chain and it == 0:
                faults = _planted_readings(torch, pm, dr, collision, seed,
                                           got, peak)
                require(collision == "mean" or faults["drop"] > gate,
                        f"{label}: the gate passes a dropped pair "
                        f"({faults['drop']:.3f} ulps)")
                planted = ("; a planted fault reads " + ", ".join(
                    f"{k} {v:.3f}" for k, v in faults.items()))
            log(f"[variants] {label} step {it} {side}: {scaled:.3f} bf16 "
                f"ulps of the operands' scale (gate {gate}; {above} of "
                f"{g.numel()} entries above 1; {raw} raw ulps), max_abs_err "
                f"{err:.3e}, the same bits twice: {same}{planted}")
    return worst


def phase_variant_kernels(torch, dev, seed: int):
    """Phase 9's kernels: K0a's bf16 and mean/sum variants and K0b on bf16
    tables at the headline shape, each held against its plain version and
    timed beside its bound.  Returns their ``{"kernels"}`` entries."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.ops import cuda_loss
    from cu2rec_torch.ops.loss import packed_error_sums_reference
    from cu2rec_torch.ops.packed import (PackedModel, packed_step,
                                         packed_step_reference)
    from cu2rec_torch.ops.sgd import INT32_MAX, prng_key, sample_items

    csr = _headline_csr(seed)
    pm32 = _packed_tables(torch, U, I, F, seed, dev)
    pm16 = PackedModel(T_u=pm32.T_u.bfloat16(), T_i=pm32.T_i.bfloat16(),
                       global_bias=pm32.global_bias, n_factors=F)
    site = _tpu_kernel_site("ops/packed.py", "def packed_step(")
    entries = []
    # The runs of a mean/sum step (the same for every table dtype).
    dr = to_device(csr, dev)
    torch.cuda.synchronize()
    _check_run_order(torch, dr, seed, "uniform items")
    del dr
    for dtype, collision in VARIANTS:
        pm = pm16 if dtype == "bfloat16" else pm32
        elem = pm.T_u.element_size()
        dr = to_device(csr, dev, item_major=collision == "twin")
        torch.cuda.synchronize()
        err = _check_variant(torch, pm, dr, dtype, collision, seed)
        loop_ms, _host, enqueue_ms = _time_steps(torch, pm, dr, collision)
        best = torch.full((I,), INT32_MAX, dtype=torch.int32, device=dev)
        counts = torch.zeros(I, dtype=torch.int32, device=dev)
        mu = float(pm.global_bias)

        def step(it=7):
            packed_step(pm, dr, _hp(), prng_key(1), it, collision=collision,
                        best=best if collision == "first_wins" else None,
                        counts=counts if collision in ("mean", "sum")
                        else None, mu=mu)

        ms = time_ms(step, [()], reps=50, hold=True)
        plain_ms = time_ms(lambda: packed_step_reference(
            pm, dr, _hp(), prng_key(1), 7, collision=collision), [()],
            reps=3)
        items, _r, has = sample_items(prng_key(1), 7, dr.indptr, dr.indices,
                                      dr.data)
        hit = int(torch.unique(items[has]).numel())
        n_bytes = _step_bytes(csr, F, collision, False, True, elem)
        n_pairs = int(has.sum())
        n_ops = 5 * 128 * (U + I) + (6 * 128 * n_pairs
                                     if collision in ("mean", "sum") else 0)
        library_ms = None
        if collision in ("mean", "sum"):
            # The item side's scatter-add as one PyTorch call over the
            # step's pairs (its order is not fixed on the card).
            T = pm.T_i.clone()
            idx = items[has]
            src = torch.randn((n_pairs, pm.width), device=dev).to(
                pm.T_i.dtype)
            library_ms = time_ms(lambda: T.index_add_(0, idx, src), [()],
                                 reps=20)
        entry = _entry(f"sgd_step/{dtype}/{collision}", site, err, ms,
                       plain_ms, n_bytes, n_ops, library_ms,
                       {"U": U, "I": I, "F": F, "W": 128, "nnz": N_HEADLINE,
                        "dtype": dtype, "collision": collision,
                        "pairs": n_pairs, "items_hit": hit},
                       semantics="packed_step", source="sgd_step")
        entry.update(loop_ms=loop_ms, enqueue_ms=enqueue_ms)
        if collision in ("mean", "sum"):
            # Where a collision step's time goes, kernel by kernel; the item
            # side is the kernel time outside the user kernel.
            busy_ms, _host_ms, top, side_ms = _profile_steps(torch, pm, dr,
                                                             collision)
            entry.update(kernel_ms=busy_ms, item_side_ms=side_ms)
            log(f"[variants] sgd_step {dtype}/{collision} under the "
                f"profiler: {busy_ms:.4f} ms of kernel time a step, the "
                f"item side {side_ms:.4f} ms (index_add_ "
                f"{library_ms:.4f} ms); "
                + "; ".join(f"{_short(k)} {t / n * 1e3:.2f} us x{n}"
                            for k, t, n in top))
        if library_ms is not None:
            entry["library_call"] = "Tensor.index_add_ of the step's pairs"
        log(f"[variants] sgd_step {dtype}/{collision}: {ms:.4f} ms a step "
            f"on the card (the stream held while 50 steps are enqueued), "
            f"{loop_ms:.4f} ms a step as the trainer's loop runs them "
            f"(host enqueue {enqueue_ms:.4f} ms a step)")
        entries.append(entry)
        del dr

    # Skewed items: the top item holds ML-20M's 4.7% of the ratings, so
    # about 6,500 users draw it in a step, a run for the long-run kernel.
    skew = _headline_csr(seed, item_power=SKEW_POWER)
    dr = to_device(skew, dev)
    torch.cuda.synchronize()
    _check_run_order(torch, dr, seed, "skewed items")
    del dr
    counts = torch.zeros(I, dtype=torch.int32, device=dev)
    for dtype, collision in (("float32", "mean"), ("bfloat16", "sum")):
        pm = pm16 if dtype == "bfloat16" else pm32
        dr = to_device(skew, dev)
        torch.cuda.synchronize()
        _check_variant(torch, pm, dr, dtype, collision, seed)
        items, _r, has = sample_items(prng_key(1), 7, dr.indptr, dr.indices,
                                      dr.data)
        top = int(torch.bincount(items[has]).max())
        ms = time_ms(lambda: packed_step(pm, dr, _hp(), prng_key(1), 7,
                                         collision=collision, counts=counts,
                                         mu=3.5),
                     [()], reps=20, hold=True)
        busy_ms, _host_ms, top_k, side_ms = _profile_steps(torch, pm, dr,
                                                           collision)
        name = f"sgd_step/{dtype}/{collision}"
        next(e for e in entries if e["name"] == name).update(
            skewed_ms=ms, skewed_top_run=top, skewed_kernel_ms=busy_ms,
            skewed_item_side_ms=side_ms)
        log(f"[variants] {name} with skewed items (the longest run "
            f"{top} pairs): {ms:.4f} ms a step on the card; under the "
            f"profiler {busy_ms:.4f} ms of kernel time a step, the item "
            f"side {side_ms:.4f} ms; "
            + "; ".join(f"{_short(k)} {t / n * 1e3:.2f} us x{n}"
                        for k, t, n in top_k))
        del dr
    del skew

    # K0b over bf16 tables: all 20,000,000 ratings.
    dr = to_device(csr, dev)
    args = (pm16.T_u, pm16.T_i, 3.5, dr.row_ids, dr.indices, dr.data, F)
    got = cuda_loss.packed_error_sums_cuda(*args)
    again = cuda_loss.packed_error_sums_cuda(*args)
    want = packed_error_sums_reference(pm16.T_u, pm16.T_i,
                                       pm16.global_bias, *args[3:])
    torch.cuda.synchronize()
    require(torch.equal(got, again), "eval_error on bf16 tables is not "
            "deterministic")
    rel = float(((got - want).abs() / want.abs()).max())
    require(rel <= EVAL_RTOL, f"eval_error on bf16 tables differs from its "
            f"plain version by {rel:.3e} (relative)")
    ms = time_ms(cuda_loss.packed_error_sums_cuda, [args], reps=20)
    plain_ms = time_ms(packed_error_sums_reference,
                       [(pm16.T_u, pm16.T_i, pm16.global_bias) + args[3:]],
                       reps=3)
    entry = _entry(
        "eval_error/bfloat16", _tpu_kernel_site("ops/loss.py",
                                                "def _eval_packed_jit"),
        float((got - want).abs().max()), ms, plain_ms,
        12 * N_HEADLINE + 2 * (F + 1) * (U + I) + 16,
        (2 * (F + 1) + 4) * N_HEADLINE, None,
        {"U": U, "I": I, "F": F, "W": 128, "nnz": N_HEADLINE,
         "dtype": "bfloat16"}, semantics="_eval_packed_jit",
        source="eval_error")
    entry["l2_gather_tb_s"] = N_HEADLINE * 2 * (F + 1) / (ms * 1e-3) / 1e12
    log(f"[variants] eval_error on bf16 tables: sums {got.tolist()}, "
        f"relative difference from the plain version {rel:.3e}, the same "
        f"bits twice; item-row gather through L2 "
        f"{N_HEADLINE * 2 * (F + 1) / 1e9:.2f} GB at "
        f"{entry['l2_gather_tb_s']:.3f} TB/s")
    entries.append(entry)
    del dr, csr
    torch.cuda.empty_cache()
    return entries


def _test_rmse(text: str):
    """[(iteration, test RMSE)] of mf's TEST lines."""
    rows = [METRIC_LINE.match(ln) for ln in text.splitlines()
            if ln.startswith(("TRAIN:", "TEST:"))]
    require(rows and all(rows), "a TRAIN/TEST line does not parse")
    return [(int(m[2]), float(m[4])) for m in rows if m[1] == "TEST"]


def _gate_rmse(what: str, test_rmse, mean_rmse: float) -> float:
    first, final = test_rmse[0][1], test_rmse[-1][1]
    require(np.isfinite(final) and final < first and final < mean_rmse,
            f"{what}: test RMSE {final} is not below iteration 1's {first} "
            f"and the global mean's {mean_rmse}")
    return final


def _mean_rmse(train: str, test: str) -> float:
    """Test RMSE of the train split's global mean."""
    from cu2rec_torch.data.ratings import read_ratings_csv

    mu = read_ratings_csv(train).global_bias
    r = read_ratings_csv(test).ratings.astype(np.float64)
    return float(np.sqrt(np.mean((r - mu) ** 2)))


def _model_from_components(out: Path, base: str, device):
    from cu2rec_torch.data.ratings import load_matrix
    from cu2rec_torch.models.state import model_from_numpy

    comps = {c: load_matrix(str(out / f"{base}{c}.csv"))
             for c in ("p", "q", "user_bias", "item_bias", "global_bias")}
    for c in ("user_bias", "item_bias", "global_bias"):
        comps[c] = comps[c].reshape(-1)
    return model_from_numpy(comps, device)


def _client_run(engine, train_csr, cfg, workdir: Path, card: str):
    """``ServeClient`` against the serving daemon over a unix socket:
    CLIENT_CALLS single-user recommends (auto-batched), each the engine's
    own top-10 for that user, and one fold-in passed through.  Returns
    requests/s."""
    import socket

    from cu2rec_torch.serve.client import ServeClient
    from cu2rec_torch.serve.daemon import ServingDaemon, run_stdio_connection

    daemon = ServingDaemon(engine, train_csr=train_csr, cfg=cfg,
                           window_ms=1.0)
    path = str(workdir / "serve.sock")
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(1)
    daemon.start()

    def serve_one():
        conn, _ = srv.accept()
        try:
            run_stdio_connection(daemon, conn.makefile("r", encoding="utf-8"),
                                 conn.makefile("w", encoding="utf-8"))
        finally:
            conn.close()

    server = threading.Thread(target=serve_one, daemon=True)
    server.start()
    users = np.arange(CLIENT_CALLS) % train_csr.n_users
    try:
        with ServeClient(path, batch_size=256, flush_after_ms=2.0) as c:
            c.recommend(0, k=10).result(timeout=60)      # warm the path
            t0 = time.perf_counter()
            futs = [c.recommend(int(u), k=10) for u in users]
            results = [f.result(timeout=120) for f in futs]
            wall = time.perf_counter() - t0
            rated = [int(i) for i in train_csr.indices[
                train_csr.indptr[0]:train_csr.indptr[1]]][:20]
            fold = c.fold_in(rated, [5.0] * len(rated), k=10,
                             iterations=50).result(timeout=60)
            stats = c.stats().result(timeout=60)
    finally:
        server.join(timeout=60)
        daemon.close()
        srv.close()
    require(not server.is_alive(), "the daemon's connection did not end")
    n_users = train_csr.n_users
    vals, idx = engine.recommend_known(np.arange(n_users), train_csr, k=10)
    for u, r in zip(users, results):
        require("error" not in r, f"recommend {u}: {r}")
        s = np.asarray(vals[u])
        ties = np.abs(s[:, None] - s[None, :]) <= 1e-5
        same = [a == b or ties[n].sum() > 1 for n, (a, b) in
                enumerate(zip(r["items"], idx[u].tolist()))]
        require(len(r["items"]) == len(idx[u]) and all(same)
                and np.allclose(r["scores"], s, rtol=1e-5, atol=1e-5),
                f"recommend {u}: not the engine's own top-10")
    require(len(fold["items"]) == 10 and not set(fold["items"]) & set(rated),
            f"fold_in through the client: {fold}")
    rps = CLIENT_CALLS / wall
    log(f"[client] {CLIENT_CALLS} single-user recommends through "
        f"ServeClient in {wall:.3f} s, {rps:.1f} requests/s, each the "
        f"engine's own top-10; {stats['requests']} requests and "
        f"{stats['batches']} batches at the daemon; one fold-in passed "
        f"through; on {card}")
    return rps


def phase_variants(torch, seed: int, workdir: Path, card: str,
                   f32_rmse: float, device: str = "cuda"):
    """Phase 9's entry points, with the launch counts set to 0 before them
    and read after: ``mf --dtype bfloat16`` and ``mf --collision mean`` on
    phase 5's planted CSVs, the trainer for the other variants, ``predict``
    with a bf16 config, ``mf --algo als`` in float32 and bf16 on the
    ML-100K-shaped CSVs, ``foldin_ranking_eval`` explicit and implicit,
    and ``ServeClient`` against the daemon.  Returns the launch counts by
    variant."""
    from cu2rec_torch.cli import mf, predict
    from cu2rec_torch.data import build_csr, read_ratings_csv
    from cu2rec_torch.ops import cuda_linalg, cuda_loss, cuda_sgd
    from cu2rec_torch.serve.engine import ServingEngine
    from cu2rec_torch.serve.recommend import foldin_ranking_eval
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.train.trainer import train
    from cu2rec_torch.utils.config import Config
    from cu2rec_torch.utils.metrics import MetricsLogger

    train_csv, test_csv = (str(workdir / f"{n}.csv")
                           for n in ("train", "test"))
    mean_rmse = _mean_rmse(train_csv, test_csv)
    cuda_sgd.LAUNCHES.clear()
    cuda_loss.LAUNCHES.clear()
    cuda_linalg.LAUNCHES = 0
    t_phase = time.perf_counter()
    for what, opts in (("--dtype bfloat16", ["--dtype", "bfloat16"]),
                       ("--collision mean", ["--collision", "mean"])):
        out = workdir / f"out_{opts[1]}"
        t0 = time.perf_counter()
        text = _capture(mf.main, ["-c", str(workdir / "train.cfg"),
                                  train_csv, test_csv, "--outdir", str(out),
                                  "--device", device] + opts)
        final = _gate_rmse(f"mf {what}", _test_rmse(text), mean_rmse)
        log(f"[variants] mf {what}: test RMSE {final:.6f} (float32 "
            f"first_wins {f32_rmse:.6f}, global mean {mean_rmse:.6f}), "
            f"{time.perf_counter() - t0:.1f} s wall on {card}")

    # The variants no mf run drives, through the trainer.
    rd_tr, rd_te = read_ratings_csv(train_csv), read_ratings_csv(test_csv)
    n_users = max(rd_tr.n_users, rd_te.n_users)
    n_items = max(rd_tr.n_items, rd_te.n_items)
    tr = build_csr(rd_tr, n_users=n_users, n_items=n_items)
    te = build_csr(rd_te, n_users=n_users, n_items=n_items)
    done = {("bfloat16", "first_wins"), ("float32", "mean")}
    for dtype, collision in VARIANTS:
        if (dtype, collision) in done:
            continue
        cfg = Config(total_iterations=VARIANT_ITERATIONS, n_factors=F,
                     learning_rate=0.05, seed=seed, check_error=10,
                     collision_policy=collision, dtype=dtype)
        _model, losses = train(tr, te, cfg, rd_tr.global_bias,
                               logger=MetricsLogger(verbose=False),
                               device=device)
        first, final = losses[1], losses[VARIANT_ITERATIONS]
        require(np.isfinite(final) and final < first,
                f"train {dtype}/{collision}: test RMSE {final} is not below "
                f"iteration 1's {first}")
        log(f"[variants] train {dtype}/{collision}: test RMSE {first:.6f} "
            f"at iteration 1 -> {final:.6f} at {VARIANT_ITERATIONS}")

    # predict with a bf16 config, from the bf16 run's components.
    out = workdir / "out_bfloat16"
    cfg16 = workdir / "bf16.json"
    cfg16.write_text(json.dumps({"total_iterations": 100, "n_factors": F,
                                 "learning_rate": 0.05, "seed": seed,
                                 "dtype": "bfloat16"}))
    rng = np.random.default_rng(seed + 4)
    rated = sorted(rng.choice(I, 20, replace=False).tolist())
    user = workdir / "user16.csv"
    user.write_text("userId,itemId,rating\n" + "".join(
        f"1,{i + 1},{r}\n" for i, r in
        zip(rated, rng.integers(1, 11, 20) / 2.0)))
    scores, ranks = _predictions(_capture(predict.main, [
        "-c", str(cfg16), "-i", str(out / f"train_f{F}_item_bias.csv"),
        "-g", str(out / f"train_f{F}_global_bias.csv"),
        "-q", str(out / f"train_f{F}_q.csv"), str(user),
        "--device", device]))
    require(len(scores) == I and np.all(np.isfinite(scores))
            and sorted(i for i, _ in ranks)
            == sorted(set(range(I)) - set(rated)),
            "predict with a bf16 config: wrong predictions or ranking")
    log(f"[variants] predict with a bf16 config: {len(scores)} finite "
        f"predictions, the {len(ranks)} unrated items ranked")

    # ALS in float32 and bf16 on the ML-100K-shaped CSVs.
    paths = _family_csvs(seed, workdir)
    fam_mean = _mean_rmse(paths["explicit", "train"],
                          paths["explicit", "test"])
    als_cfg = workdir / "als.cfg"
    als_cfg.write_text(f"0 {SWEEPS} {F} 0.05 {seed} {FAMILY_REG} "
                       f"{FAMILY_REG} {FAMILY_REG} {FAMILY_REG} 32 1 2 0.2\n")
    als_rmse = {}
    for dtype in ("float32", "bfloat16"):
        out = workdir / f"als_{dtype}"
        text = _capture(mf.main, ["-c", str(als_cfg),
                                  paths["explicit", "train"],
                                  paths["explicit", "test"], "--algo", "als",
                                  "--dtype", dtype, "--outdir", str(out),
                                  "--device", device])
        als_rmse[dtype] = _gate_rmse(f"mf --algo als --dtype {dtype}",
                                     _test_rmse(text), fam_mean)
    log(f"[variants] mf --algo als --dtype bfloat16: test RMSE "
        f"{als_rmse['bfloat16']:.6f} (float32 {als_rmse['float32']:.6f}, "
        f"global mean {fam_mean:.6f})")

    # foldin_ranking_eval on the bf16 ALS model (explicit, liked held-out
    # items) and on an iALS model of the implicit CSVs.
    ex_tr = build_csr(read_ratings_csv(paths["explicit", "train"]),
                      n_users=ML100K[0], n_items=ML100K[1])
    rd = read_ratings_csv(paths["explicit", "test"])
    liked = rd.ratings >= 4.0
    from cu2rec_torch.data.csr import csr_from_arrays
    ex_te = csr_from_arrays(rd.users[liked], rd.items[liked],
                            rd.ratings[liked], ML100K[0], ML100K[1])
    engine = ServingEngine(_model_from_components(
        workdir / "als_bfloat16", f"explicit_train_f{F}_", device),
        device=device)
    fold_cfg = Config(total_iterations=100, n_factors=F, learning_rate=0.05,
                      P_reg=FAMILY_REG, user_bias_reg=FAMILY_REG, seed=seed,
                      is_train=False)
    random_recall = 10 / ML100K[1]
    explicit = foldin_ranking_eval(engine, ex_tr, ex_te, cfg=fold_cfg, k=10,
                                   max_users=512)
    im_tr, im_te = (build_csr(read_ratings_csv(paths["implicit", s]),
                              n_users=ML100K[0], n_items=ML100K[1])
                    for s in ("train", "test"))
    ials_model, _ = train_ials(im_tr, im_te, Config(
        total_iterations=SWEEPS, n_factors=F, P_reg=FAMILY_REG,
        Q_reg=FAMILY_REG, seed=seed), alpha=ALPHA,
        logger=MetricsLogger(verbose=False), device=device)
    implicit = foldin_ranking_eval(ServingEngine(ials_model, device=device),
                                   im_tr, im_te, k=10, max_users=512,
                                   mode="implicit", alpha=ALPHA,
                                   reg=FAMILY_REG)
    for mode, res in (("explicit", explicit), ("implicit", implicit)):
        require(res["n_users"] > 0 and res["recall"] > random_recall,
                f"foldin_ranking_eval {mode}: recall@10 {res['recall']} is "
                f"not above a random 10/I = {random_recall:.5f}")
        log(f"[variants] foldin_ranking_eval {mode} over {res['n_users']} "
            f"users: recall@10 {res['recall']:.4f} (a random 10/I "
            f"{random_recall:.4f}), ndcg@10 {res['ndcg']:.4f}")

    rps = _client_run(engine, ex_tr, fold_cfg, workdir, card)
    launches = {f"{_dtype_name(d)}/{policy}": n
                for (d, policy), n in cuda_sgd.LAUNCHES.items()}
    launches.update({f"eval_error/{_dtype_name(d)}": n
                     for d, n in cuda_loss.LAUNCHES.items()})
    launches["ridge_cholesky"] = cuda_linalg.LAUNCHES
    want = [f"{d}/{c}" for d, c in VARIANTS] + ["eval_error/bfloat16"]
    require(device == "cpu" or all(launches.get(k) for k in want),
            f"phase 9 did not launch every variant: {launches}")
    log(f"[variants] launches {launches}; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, {"client_requests_s": rps,
                      "foldin_recall": {"explicit": explicit["recall"],
                                        "implicit": implicit["recall"]},
                      "als_test_rmse": als_rmse}


# -- phase 10: sharded training on the card --------------------------------

SHARD_POLICIES = ("first_wins", "twin", "mean", "sum")
# The gloo grids of ranks sharing the card, at ML-1M's depth (users, items,
# planted ratings) and the headline's F: gloo stages each CUDA all_reduce
# through the host, so these runs check the grid, they do not time it.
SHARD_GRIDS = ((2, 1), (2, 2))
ML1M = (6_040, 3_706, 1_000_209)
SHARD_STEPS = 3
# The sharded engine against the one-device engine, float32: tables within
# 1e-6 (first_wins, twin) and 1e-5 (mean, sum) of max(1, |entry|), the eval
# within rtol 1e-5.
SHARD_ATOL = {"first_wins": 1e-6, "twin": 1e-6, "mean": 1e-5, "sum": 1e-5}
SHARD_EVAL_RTOL = 1e-5
# A bf16 engine's test RMSE against the float32 engine's (bf16 tables
# differ from float32 ones by 2^-8 of an entry).
BF16_EVAL_RTOL = 1e-2
# The families at dp = 2 against one device, tables over max(1, |entry|):
# the row-sharded sweeps multiply each chunk's rows in batches of other
# sizes, and iALS's systems at alpha 40 are ill-conditioned enough to grow
# those roundings (its objective must still agree within 1e-4).
FAMILY_SHARD_GATES = {"als": 1e-3, "ials": 1e-2, "bpr": 1e-5}
FAMILY_SHARD_RTOL = 1e-4
BPR_SHARD_STEPS = 50
RANK_TIMEOUT = 600.0


def _shard_cfg(seed: int, policy: str, dtype: str = "float32"):
    from cu2rec_torch.utils.config import Config

    return Config(n_factors=F, collision_policy=policy, dtype=dtype,
                  seed=seed)


def _every_nth(csr, n: int):
    """The CSR of every n-th rating (the engines' test split)."""
    from cu2rec_torch.data.csr import CSRRatings

    sel = np.arange(0, csr.nnz, n)
    rows = csr.row_ids[sel]
    indptr = np.zeros(csr.n_users + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=csr.n_users), out=indptr[1:])
    return CSRRatings(indptr=indptr, indices=csr.indices[sel],
                      data=csr.data[sel], n_users=csr.n_users,
                      n_items=csr.n_items)


def _model_diff(torch, a, b) -> float:
    """The largest difference of two models' entries, each over
    max(1, |b's entry|): float32 keeps a relative precision, and a run
    under sum may grow its entries well past 1."""
    return max(float(((x.float() - y.float()).abs()
                      / y.float().abs().clamp(min=1.0)).max())
               for x, y in zip((a.P, a.Q, a.user_bias, a.item_bias),
                               (b.P, b.Q, b.user_bias, b.item_bias)))


def _shard_bytes(csr, policy: str, elem: int, dT_cols: int) -> int:
    """The bytes of the sharded step (``csrc/sgd_sharded.cu``): the
    one-device step's, and under every policy but twin, where the item
    side writes a float32 dT of ``dT_cols`` columns (0: none, at dp = 1),
    dT written and read and the apply's read of T_i over those columns.
    At dp > 1 the step's dT has ``delta_width(F)`` columns; the design it
    replaced wrote all 128 at every dp."""
    n = _step_bytes(csr, F, policy, False, True, elem)
    if policy != "twin":
        n += csr.n_items * dT_cols * (8 + elem)
    return n


def _direct_is_applied_deltas(torch, pm, drs, key, hp, mesh, policy: str,
                              label: str) -> None:
    """At dp = 1 the sharded item side writes the new T_i itself; the same
    steps' item side written as dT (``_sharded_step(..., deltas=True)``), as
    ``(T_i.float() + dT)`` rounded to the table type and padded with zero
    columns, must give the same bits, on each of ``drs``' ratings (uniform
    and power-law items); and no step may launch the apply."""
    from cu2rec_torch.ops import cuda_sgd

    wd = cuda_sgd.delta_width(F)
    ints = torch.int16 if pm.T_i.dtype == torch.bfloat16 else torch.int32
    kw = dict(n_factors=F, mesh=mesh, n_users_global=U, collision=policy)
    for skew, dr in drs.items():
        a0 = cuda_sgd.SHARD_APPLIES.total()
        for it in (0, 3):
            got = cuda_sgd.sgd_step_sharded_cuda(pm.T_u, pm.T_i, 3.5, dr, hp,
                                                 key, it, **kw)[1]
            dT = cuda_sgd._sharded_step(pm.T_u, pm.T_i, 3.5, dr, hp, key,
                                        it, **kw, deltas=True)[1]
            want = torch.zeros_like(pm.T_i)
            want[:, :wd] = (pm.T_i[:, :wd].float() + dT).to(pm.T_i.dtype)
            torch.cuda.synchronize()
            differ = int((got.view(ints) != want.view(ints)).sum())
            require(differ == 0 and tuple(dT.shape) == (I, wd),
                    f"{label} {skew} step {it}: the item side written "
                    f"directly differs from T_i + dT ({tuple(dT.shape)}) "
                    f"in {differ} entries")
            del got, dT, want
        require(cuda_sgd.SHARD_APPLIES.total() == a0,
                f"{label}: a world of one launched the apply")
    log(f"[shard] {label}: T_i written directly = T_i + dT ({wd} of 128 "
        f"columns) rounded, bit for bit, steps 0 and 3 on "
        f"{' and '.join(drs)} items; no apply launched")


def _shard_headline(torch, dev, seed: int, card: str):
    """Phase 10 (a): a world of 1 under NCCL at the headline shape.  K0a's
    sharded mode against its plain version (two steps a variant, float32
    within STEP_ATOL, bf16 within one ulp of the operands' scale: the
    sharded step rounds once), timed with the stream held beside the fused
    step; then the engine for each policy in float32 (against the
    one-device engine) and bf16 (finite, its RMSE near float32's).
    Returns (kernel entries, {"dtype/policy": launches})."""
    import torch.distributed as dist

    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.experiments.common import time_ms
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.ops.packed import PackedModel, packed_step, unpack
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.parallel.distributed import initialize
    from cu2rec_torch.parallel.sharded import (
        ShardedEngine, _local_step_packed, make_mesh,
    )
    from cu2rec_torch.train.trainer import SingleChipEngine

    entries = []
    with tempfile.TemporaryDirectory(prefix="cu2rec_rdzv_") as tmp:
        initialize("nccl", f"file://{tmp}/rendezvous", 1, 0, dev)
        try:
            mesh = make_mesh(1, 1)
            csr = _headline_csr(seed)
            dr = to_device(csr, dev, item_major=True)
            drs = {"uniform": dr, "power-law": to_device(
                _headline_csr(seed, item_power=SKEW_POWER), dev)}
            key, hp = prng_key(seed), _hp()
            base = _packed_tables(torch, U, I, F, seed, dev)
            site = _tpu_kernel_site("parallel/sharded.py",
                                    "def _local_step_packed(")
            for dtype in ("float32", "bfloat16"):
                tdt = getattr(torch, dtype)
                pm = PackedModel(T_u=base.T_u.to(tdt), T_i=base.T_i.to(tdt),
                                 global_bias=base.global_bias, n_factors=F)

                # The buffers a run of steps carries (a step makes its own
                # without them); the global bias as a float, as the loop
                # passes it (reading it from the card would wait for the
                # card).
                best = torch.full((I,), 2 ** 31 - 1, dtype=torch.int32,
                                  device=dev)
                counts = torch.zeros(I, dtype=torch.int32, device=dev)

                def bufs(policy):
                    return dict(
                        best=best if policy == "first_wins" else None,
                        counts=counts if policy in ("mean", "sum")
                        else None)

                def sharded(it, policy):
                    return cuda_sgd.sgd_step_sharded_cuda(
                        pm.T_u, pm.T_i, 3.5, dr, hp, key, it, n_factors=F,
                        mesh=mesh, n_users_global=U, collision=policy,
                        **bufs(policy))

                def plain(it, policy):
                    return _local_step_packed(
                        pm.T_u, pm.T_i, pm.global_bias, dr.indptr,
                        dr.indices, dr.data, hp, key, it, U, F,
                        dr.it_indptr, dr.it_users, dr.it_vals, mesh=mesh,
                        train_items=True, collision=policy)

                for policy in SHARD_POLICIES:
                    label = f"sgd_sharded {dtype}/{policy}"
                    worst = 0.0
                    for it in (0, 3):
                        got, want = sharded(it, policy), plain(it, policy)
                        torch.cuda.synchronize()
                        for side, g, w, p in (("T_u", got[0], want[0],
                                               pm.T_u),
                                              ("T_i", got[1], want[1],
                                               pm.T_i)):
                            require(g.dtype == p.dtype,
                                    f"{label}: {side} is {g.dtype}")
                            err = float((g.float() - w.float()).abs().max())
                            worst = max(worst, err)
                            if dtype == "float32":
                                require(torch.equal((g != p).any(1),
                                                    (w != p).any(1)),
                                        f"{label} step {it}: the changed "
                                        f"rows of {side} differ")
                                require(err <= STEP_ATOL,
                                        f"{label} step {it}: {side} "
                                        f"differs by {err}")
                                continue
                            scaled, above, raw = _bf16_error(torch, g, w, p)
                            require(scaled <= 1.0,
                                    f"{label} step {it}: {side} differs by "
                                    f"{scaled:.3f} bf16 ulps of the "
                                    f"operands' scale ({above} entries "
                                    f"above 1, {raw} raw ulps)")
                        del got, want
                    if policy != "twin":
                        _direct_is_applied_deltas(torch, pm, drs, key, hp,
                                                  mesh, policy, label)
                    ms = time_ms(lambda: sharded(7, policy), [()], reps=20,
                                 hold=True)
                    fused_ms = time_ms(lambda: packed_step(
                        pm, dr, hp, key, 7, collision=policy, mu=3.5,
                        **bufs(policy)), [()], reps=20, hold=True)
                    plain_ms = time_ms(lambda: plain(7, policy), [()],
                                       reps=3)
                    elem = 4 if dtype == "float32" else 2
                    wd = cuda_sgd.delta_width(F)
                    e = _entry(f"sgd_sharded/{dtype}/{policy}", site, worst,
                               ms, plain_ms,
                               _shard_bytes(csr, policy, elem, 0),
                               5 * 128 * (U + I), None,
                               {"U": U, "I": I, "F": F, "W": 128,
                                "nnz": N_HEADLINE, "grid": [1, 1],
                                "dtype": dtype, "collision": policy},
                               semantics="_local_step_packed",
                               source="sgd_sharded")
                    e["fused_ms"] = fused_ms
                    full = _shard_bytes(csr, policy, elem, 128)
                    log(f"[shard] {label}: the split step {ms:.4f} ms "
                        f"held, the fused K0a step {fused_ms:.4f} ms in the "
                        f"same call ({ms - fused_ms:+.4f} ms, "
                        f"{(ms / fused_ms - 1) * 100:+.1f}%), bound "
                        f"{e['bound_ms']:.4f} ms (the one-device step's "
                        f"bytes; at dp > 1 "
                        f"{_shard_bytes(csr, policy, elem, wd) / 1e6:.2f} "
                        f"MB; the full-width dT design moved "
                        f"{full / 1e6:.2f} MB, a bound of "
                        f"{_bound(full, 5 * 128 * (U + I))[0]:.4f} ms); "
                        f"max_abs_err {worst:.3e} on {card}")
                    entries.append(e)
                del pm
            del dr, drs
            torch.cuda.empty_cache()

            # The main path: the engine through a few steps.
            test = _every_nth(csr, 20)
            model = unpack(base)
            f32_eval = {}
            cuda_sgd.SHARD_LAUNCHES.clear()
            cuda_sgd.SHARD_APPLIES.clear()
            for dtype in ("float32", "bfloat16"):
                for policy in SHARD_POLICIES:
                    cfg = _shard_cfg(seed, policy, dtype)
                    eng = ShardedEngine(csr, test, cfg, mesh=mesh)
                    st = eng.run(eng.prepare(model), hp, 0, SHARD_STEPS)
                    ev = eng.evaluate(st, "test")
                    got = eng.finalize(st)
                    del eng, st
                    if dtype == "bfloat16":
                        require(all(bool(torch.isfinite(t.float()).all())
                                    for t in (got.P, got.Q)) and
                                abs(ev[0] - f32_eval[policy])
                                <= BF16_EVAL_RTOL * f32_eval[policy],
                                f"sharded bf16 {policy}: RMSE {ev[0]} against "
                                f"float32's {f32_eval[policy]}")
                        log(f"[shard] engine bf16/{policy}, world of 1 "
                            f"(NCCL): {SHARD_STEPS} steps, test RMSE "
                            f"{ev[0]:.6f} (float32 {f32_eval[policy]:.6f})")
                        continue
                    one = SingleChipEngine(csr, test, cfg, device=dev)
                    s1 = one.run(one.prepare(model), hp, 0, SHARD_STEPS)
                    ev1 = one.evaluate(s1, "test")
                    want = one.finalize(s1)
                    del one, s1
                    f32_eval[policy] = ev[0]
                    diff = _model_diff(torch, got, want)
                    rel = abs(ev[0] - ev1[0]) / ev1[0]
                    require(diff <= SHARD_ATOL[policy] and
                            rel <= SHARD_EVAL_RTOL,
                            f"sharded {policy} at the headline shape: tables "
                            f"{diff:.3e} (gate {SHARD_ATOL[policy]}), test "
                            f"RMSE {ev[0]} against one device's {ev1[0]}")
                    log(f"[shard] engine float32/{policy}, world of 1 "
                        f"(NCCL), {SHARD_STEPS} steps against the one-device "
                        f"engine: tables {diff:.3e}, test RMSE {ev[0]:.6f} "
                        f"({rel:.2e} relative)")
            launches = {f"{_dtype_name(k[0])}/{k[1]}": n
                        for k, n in cuda_sgd.SHARD_LAUNCHES.items()}
            require(not cuda_sgd.SHARD_APPLIES,
                    f"a world of one launched the apply: "
                    f"{dict(cuda_sgd.SHARD_APPLIES)}")
        finally:
            dist.destroy_process_group()
    del csr, test, base
    torch.cuda.empty_cache()
    return entries, launches


def _ml1m_data(seed: int):
    """ML-1M-shaped planted ratings, split 90/10: (train CSR, test CSR,
    train mean)."""
    from cu2rec_torch.data.csr import csr_from_arrays
    from cu2rec_torch.data.synth import generate_planted, split_arrays

    n_users, n_items, n = ML1M
    d = generate_planted(n_users, n_items, n, seed=seed)
    tr, te = split_arrays(d.users, d.items, d.ratings, 0.9, seed=seed)
    csrs = [csr_from_arrays(*x, n_users, n_items) for x in (tr, te)]
    return csrs[0], csrs[1], float(np.mean(tr[2]))


def _csr_args(csr):
    return (csr.indptr, csr.indices, csr.data, csr.n_users, csr.n_items)


def _grid_rank(n_dp: int, n_ip: int, train, test, model_d, seed: int):
    """One rank of phase 10 (b): K0a's sharded mode against the plain local
    step over the grid's collectives (one step a policy, uncounted), then
    the engine for each policy (counted); returns what the parent checks."""
    import torch

    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.models.state import model_from_numpy, model_to_numpy
    from cu2rec_torch.ops import cuda_sgd
    from cu2rec_torch.parallel.sharded import (
        ShardedEngine, _local_step_packed, make_mesh,
    )

    mesh = make_mesh(n_dp, n_ip)
    csr, test = CSRRatings(*train), CSRRatings(*test)
    model = model_from_numpy(model_d, mesh.device)
    hp = _hp()
    engines, errs = {}, {}
    for policy in SHARD_POLICIES:
        eng = ShardedEngine(csr, test, _shard_cfg(seed, policy), mesh=mesh)
        engines[policy] = eng
        T_u, T_i, mu = eng.prepare(model)
        d = eng.train_dev
        got = cuda_sgd.sgd_step_sharded_cuda(
            T_u, T_i, float(mu), d, hp, eng.key, 0, n_factors=F, mesh=mesh,
            n_users_global=eng.n_users, collision=policy)
        want = _local_step_packed(
            T_u, T_i, mu, d.indptr, d.indices, d.data, hp, eng.key, 0,
            eng.n_users, F, d.it_indptr, d.it_users, d.it_vals, mesh=mesh,
            train_items=True, collision=policy)
        errs[policy] = max(float((g - w).abs().max())
                           for g, w in zip(got, want))
    torch.cuda.synchronize()
    cuda_sgd.SHARD_LAUNCHES.clear()
    cuda_sgd.SHARD_APPLIES.clear()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    runs = {}
    for policy, eng in engines.items():
        st = eng.run(eng.prepare(model), hp, 0, SHARD_STEPS)
        ev = eng.evaluate(st, "test")
        m = eng.finalize(st)
        runs[policy] = (model_to_numpy(m) if mesh.rank == 0 else None, ev)
    torch.cuda.synchronize()
    return {"rank": mesh.rank, "errs": errs, "runs": runs,
            "launches": {f"{_dtype_name(k[0])}/{k[1]}": n
                         for k, n in cuda_sgd.SHARD_LAUNCHES.items()},
            "applies": cuda_sgd.SHARD_APPLIES.total(),
            "memory": torch.cuda.max_memory_allocated(mesh.device)}


def _shard_grids(torch, dev, seed: int, data, card: str,
                 grids=SHARD_GRIDS, backend: str = "gloo"):
    """Phase 10 (b): 2 ranks (dp=2) and 4 ranks (dp=2, ip=2) under gloo,
    sharing the card, at ML-1M's depth: each rank holds K0a's sharded mode
    against the plain step over the grid, and rank 0's model after the
    engine's steps is held against the one-device engine on the card.
    ``grids`` and ``backend`` take others (NCCL on a host of as many cards
    as ranks).  Returns {"dtype/policy": launches} summed over the
    ranks."""
    from cu2rec_torch.models.state import model_from_numpy, model_to_numpy
    from cu2rec_torch.ops.packed import unpack
    from cu2rec_torch.parallel.distributed import launch
    from cu2rec_torch.train.trainer import SingleChipEngine

    train, test, _mu = data
    model_d = model_to_numpy(unpack(_packed_tables(
        torch, train.n_users, train.n_items, F, seed, "cpu")))
    model = model_from_numpy(model_d, dev)
    hp = _hp()
    want = {}
    for policy in SHARD_POLICIES:
        one = SingleChipEngine(train, test, _shard_cfg(seed, policy),
                               device=dev)
        st = one.run(one.prepare(model), hp, 0, SHARD_STEPS)
        want[policy] = (one.finalize(st), one.evaluate(st, "test"))
    launches = {}
    for n_dp, n_ip in grids:
        t0 = time.perf_counter()
        ranks = launch(_grid_rank, n_dp * n_ip, backend, "cuda",
                       args=(n_dp, n_ip, _csr_args(train), _csr_args(test),
                             model_d, seed), timeout=RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        for r in ranks:
            for policy, err in r["errs"].items():
                require(err <= STEP_ATOL, f"sgd_sharded {n_dp}x{n_ip} rank "
                        f"{r['rank']} {policy}: differs from the plain step "
                        f"by {err}")
            for k, n in r["launches"].items():
                launches[k] = launches.get(k, 0) + n
            # The engine's steps of the three policies with item deltas:
            # through dT and the apply exactly when dp > 1.
            want_applies = 3 * SHARD_STEPS if n_dp > 1 else 0
            require(r["applies"] == want_applies,
                    f"{n_dp}x{n_ip} rank {r['rank']}: {r['applies']} "
                    f"applies, want {want_applies}")
        for policy in SHARD_POLICIES:
            comps, ev = ranks[0]["runs"][policy]
            got = model_from_numpy(comps, "cpu")
            ref, ev1 = want[policy]
            diff = _model_diff(torch, got, ref.to("cpu"))
            rel = abs(ev[0] - ev1[0]) / ev1[0]
            require(all(r["runs"][policy][1] == ev for r in ranks),
                    f"{n_dp}x{n_ip} {policy}: the ranks' evals differ")
            require(diff <= SHARD_ATOL[policy] and rel <= SHARD_EVAL_RTOL,
                    f"{n_dp}x{n_ip} {policy}: tables {diff:.3e} (gate "
                    f"{SHARD_ATOL[policy]}), test RMSE {ev[0]} against one "
                    f"device's {ev1[0]}")
            log(f"[shard] {n_dp}x{n_ip} {backend} ranks, "
                f"{policy}: {SHARD_STEPS} steps against the one-device "
                f"engine: tables {diff:.3e}, test RMSE {ev[0]:.6f} "
                f"({rel:.2e}); kernel against plain step, worst rank "
                f"{max(r['errs'][policy] for r in ranks):.3e}")
        log(f"[shard] {n_dp}x{n_ip} at {ML1M[0]} x {ML1M[1]}, "
            f"{train.nnz} train ratings, F={F}: {wall:.1f} s wall with the "
            f"ranks' start; peak memory a rank (MB): "
            + ", ".join(f"{r['rank']}: {r['memory'] / 2**20:.1f}"
                        for r in ranks)
            + (f"; gloo stages each all_reduce through the host: a "
               f"check, not a timing" if backend == "gloo" else "")
            + f", on {card}")
    return launches


def _family_rank(train, test, mu: float, seed: int, grid=(2, 1)):
    """One rank of phase 10 (c) on ``grid`` (dp = 2): ALS and iALS two
    sweeps each (K1 launches counted on the rank), BPR's draws at two
    iterations and its training."""
    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.models.state import model_to_numpy
    from cu2rec_torch.ops import cuda_linalg
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.parallel.bpr import ShardedBPR
    from cu2rec_torch.parallel.sharded import make_mesh
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.bpr import train_bpr
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.utils.metrics import MetricsLogger

    mesh = make_mesh(*grid)
    csr, test = CSRRatings(*train), CSRRatings(*test)
    quiet = MetricsLogger(verbose=False)
    out = {"rank": mesh.rank, "blocks": (mesh.dp_index, mesh.ip_index)}
    cuda_linalg.LAUNCHES = 0
    m, losses = train_als(csr, test, _family_cfg(seed, total_iterations=2),
                          mu, logger=quiet, mesh=mesh)
    out["als"] = (model_to_numpy(m), losses, cuda_linalg.LAUNCHES)
    cuda_linalg.LAUNCHES = 0
    m, losses = train_ials(csr, test, _family_cfg(seed, total_iterations=2),
                           alpha=ALPHA, logger=quiet, mesh=mesh)
    out["ials"] = (model_to_numpy(m), losses, cuda_linalg.LAUNCHES)
    cfg = _bpr_shard_cfg(seed)
    eng = ShardedBPR(csr, cfg, mesh=mesh)
    out["draws"] = {it: [t.cpu().numpy() for t in
                         eng.draws(prng_key(seed), it)]
                    for it in (0, BPR_SHARD_STEPS - 1)}
    m, losses = train_bpr(csr, test, cfg, logger=quiet, mesh=mesh)
    out["bpr"] = (model_to_numpy(m), losses)
    return out


def _bpr_shard_cfg(seed: int):
    from cu2rec_torch.utils.config import Config

    return Config(n_factors=F, total_iterations=BPR_SHARD_STEPS,
                  check_error=BPR_SHARD_STEPS, seed=seed,
                  learning_rate=BPR_LR, P_reg=BPR_REG, Q_reg=BPR_REG,
                  user_bias_reg=BPR_REG, item_bias_reg=BPR_REG)


def _shard_families(torch, dev, seed: int, data, card: str, grid=(2, 1),
                    backend: str = "gloo"):
    """Phase 10 (c): ALS and iALS two sweeps and BPR 50 steps at dp = 2
    (gloo ranks sharing the card; ``grid`` and ``backend`` take others),
    each held against its one-device run on the card; K1 must launch on
    every rank, and BPR's ids equal the one-device draws bit for bit.
    Returns K1's launches over the ranks."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops.bpr import bpr_draws
    from cu2rec_torch.ops.sgd import prng_key
    from cu2rec_torch.parallel.distributed import launch
    from cu2rec_torch.train.als import train_als
    from cu2rec_torch.train.bpr import train_bpr
    from cu2rec_torch.train.ials import train_ials
    from cu2rec_torch.utils.metrics import MetricsLogger

    train, test, mu = data
    t0 = time.perf_counter()
    ranks = launch(_family_rank, grid[0] * grid[1], backend, "cuda",
                   args=(_csr_args(train), _csr_args(test), mu, seed, grid),
                   timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    quiet = MetricsLogger(verbose=False)
    want = {
        "als": train_als(train, test, _family_cfg(seed, total_iterations=2),
                         mu, logger=quiet, device=dev),
        "ials": train_ials(train, test,
                           _family_cfg(seed, total_iterations=2),
                           alpha=ALPHA, logger=quiet, device=dev),
        "bpr": train_bpr(train, test, _bpr_shard_cfg(seed), logger=quiet,
                         device=dev)}
    k1 = 0
    for fam in ("als", "ials", "bpr"):
        comps, losses = ranks[0][fam][:2]
        ref, ref_losses = want[fam]
        diff = _model_diff(torch, model_from_numpy(comps, "cpu"),
                           ref.to("cpu"))
        worst_loss = max(abs(losses[k] - v) / max(abs(v), 1e-12)
                         for k, v in ref_losses.items())
        gate = FAMILY_SHARD_GATES[fam]
        require(diff <= gate and worst_loss <= FAMILY_SHARD_RTOL and
                sorted(losses) == sorted(ref_losses),
                f"{fam} at {grid}: tables {diff:.3e} (gate {gate}), losses "
                f"{losses} against one device's {ref_losses}")
        line = (f"[shard] {fam} at {grid[0]}x{grid[1]} ({backend} ranks) "
                f"against one device: tables {diff:.3e}, objective "
                f"{worst_loss:.2e} relative")
        if fam != "bpr":
            per_rank = [r[fam][2] for r in ranks]
            require(all(per_rank), f"{fam} at {grid}: K1 launched "
                    f"{per_rank} times by rank")
            k1 += sum(per_rank)
            line += f"; K1 launched {per_rank} by rank"
        log(line)
    dr = to_device(train, dev, item_major=True)
    U_loc = -(-train.n_users // grid[0])
    I_loc = -(-train.n_items // grid[1])
    for it in (0, BPR_SHARD_STEPS - 1):
        full = [t.cpu().numpy() for t in bpr_draws(dr, prng_key(seed), it)]
        for r in ranks:
            got = r["draws"][it]
            d, i = r["blocks"]
            us = slice(d * U_loc, min((d + 1) * U_loc, train.n_users))
            its = slice(i * I_loc, min((i + 1) * I_loc, train.n_items))
            n, m = us.stop - us.start, its.stop - its.start
            has_u, has_y, has_v = full[1][us], full[4][its], full[8][its]
            same = (np.array_equal(got[1][:n], has_u)
                    and np.array_equal(got[0][:n][has_u], full[0][us][has_u])
                    and np.array_equal(got[2][:n], full[2][us])
                    and np.array_equal(got[4][:m], has_y)
                    and np.array_equal(got[3][:m][has_y],
                                       full[3][its][has_y])
                    and np.array_equal(got[5][:m], full[5][its])
                    and np.array_equal(got[6][:m], full[6][its])
                    and np.array_equal(got[8][:m], has_v)
                    and np.array_equal(got[7][:m][has_v],
                                       full[7][its][has_v]))
            require(same, f"BPR at {grid}, rank {r['rank']}, iteration "
                    f"{it}: the ids differ from one device's")
    log(f"[shard] BPR at {grid[0]}x{grid[1]}: the ids of iterations 0 and "
        f"{BPR_SHARD_STEPS - 1} bit-equal to one device's on every rank; "
        f"the ranks' run {wall:.1f} s wall on {card}")
    return k1


def _shard_cli(torch, seed: int, workdir: Path, card: str):
    """Phase 10 (d): ``mf --devices 1 --device cuda`` trains; ``mf
    --devices 2 --device cuda`` on a host of fewer cards raises and names
    both counts."""
    from cu2rec_torch.cli import mf

    paths = _family_csvs(seed, workdir)
    cfg = workdir / "shard.cfg"
    cfg.write_text(f"0 20 {F} 0.05 {seed} 0.02 0.02 0.02 0.02 32 10 2 "
                   f"0.2\n")
    train, test = paths["explicit", "train"], paths["explicit", "test"]
    text = _capture(mf.main, ["-c", str(cfg), train, test, "--devices", "1",
                              "--device", "cuda", "--outdir",
                              str(workdir / "shard_out")])
    lines = [METRIC_LINE.match(ln) for ln in text.splitlines()
             if ln.startswith("TEST:")]
    require(lines and all(lines), "mf --devices 1: no TEST line parses")
    n = torch.cuda.device_count()
    if n < 2:
        try:
            mf.main(["-c", str(cfg), train, test, "--devices", "2",
                     "--device", "cuda"])
        except RuntimeError as e:
            require("--devices 2" in str(e) and f"has {n}" in str(e),
                    f"mf --devices 2: the error names no counts: {e}")
            log(f"[shard] mf --devices 2 --device cuda on {n} card(s) "
                f"raises: {e}")
        else:
            raise SmokeFailure("mf --devices 2 --device cuda ran on a host "
                               f"of {n} card(s)")
    log(f"[shard] mf --devices 1 --device cuda: last {lines[-1][0]} on "
        f"{card}")


# The grids of ``--nccl``: one NCCL rank a card on a host of NCCL_RANKS;
# the grids and policies it times at the headline shape, and the steps.
NCCL_RANKS = 4
NCCL_GRIDS = ((4, 1), (2, 2), (1, 4))
NCCL_TIMED_GRIDS = ((4, 1), (2, 2))
NCCL_TIMED_POLICIES = ("first_wins", "twin")
NCCL_TIMED_STEPS = 50


def _nccl_step_rank(grid, seed: int, policies, n_steps: int):
    """One NCCL rank of ``--nccl``'s timing: ``ShardedEngine`` at the
    headline shape, a few steps to warm up, then ``n_steps`` steps
    between CUDA events (the collectives' waits included), after a
    barrier, and the host's time to enqueue them; then 10 more steps,
    rank 0's under the profiler (one session: every rank must take the
    same steps).  Returns {policy: (event ms a step, host ms a step,
    enqueue ms a step, rank 0's (busy ms a step, top kernels) or None)}."""
    import torch

    from cu2rec_torch.ops.packed import unpack
    from cu2rec_torch.parallel.distributed import barrier
    from cu2rec_torch.parallel.sharded import ShardedEngine, make_mesh

    mesh = make_mesh(*grid)
    csr = _headline_csr(seed)
    test = _every_nth(csr, 20)
    model = unpack(_packed_tables(torch, U, I, F, seed, "cpu"))
    out = {}
    for policy in policies:
        eng = ShardedEngine(csr, test, _shard_cfg(seed, policy), mesh=mesh)
        rows = eng.I_loc
        st = eng.run(eng.prepare(model), _hp(), 0, 3)
        torch.cuda.synchronize()
        barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        t_rec = time.perf_counter()
        st = eng.run(st, _hp(), 3, n_steps)
        enqueue = (time.perf_counter() - t_rec) * 1e3 / n_steps
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / n_steps
        profile = None
        barrier()
        prof = _new_profile(torch) if mesh.rank == 0 else None
        if prof is not None:
            prof.start()
        st = eng.run(st, _hp(), 3 + n_steps, 10)
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
            if _has_device_time(torch, prof):
                busy_s, top = _device_breakdown(torch, prof, top=6)
                profile = (busy_s * 1e3 / 10,
                           [(k[:48], ms / 10, n) for k, ms, n in top])
        out[policy] = (start.elapsed_time(end) / n_steps, host, enqueue,
                       profile)
        del eng, st
    out["dT"] = _dt_sum_times(torch, mesh, rows) if mesh.n_dp > 1 else None
    return out


def _dt_sum_times(torch, mesh, rows: int, reps: int = 20, turns: int = 4):
    """The SUM over dp of a rank's item deltas as the sharded step sends
    it, dT's live columns (I_loc, delta_width(F)) float32: ``turns`` turns
    of ``reps`` SUMs between CUDA events, each after a barrier: (bytes,
    [ms a SUM, one a turn])."""
    from cu2rec_torch.ops.cuda_sgd import delta_width
    from cu2rec_torch.parallel.distributed import barrier

    buf = torch.zeros((rows, delta_width(F)), dtype=torch.float32,
                      device=mesh.device)
    for _ in range(3):
        mesh.dp.sum_(buf)
    times = []
    for _ in range(turns):
        torch.cuda.synchronize()
        barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            mesh.dp.sum_(buf)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return buf.numel() * 4, times


def _nccl_timing(torch, dev, seed: int, card: str):
    """``--nccl``'s timing: the sharded engine's step on NCCL_TIMED_GRIDS
    at the headline shape, beside the one-device fused step's loop on one
    of the cards in the same call; the slowest rank's time counts."""
    from cu2rec_torch.data.csr import to_device
    from cu2rec_torch.parallel.distributed import launch

    csr = _headline_csr(seed)
    pm = _packed_tables(torch, U, I, F, seed, dev)
    one = {}
    for policy in NCCL_TIMED_POLICIES:
        dr = to_device(csr, dev, item_major=policy == "twin")
        one[policy] = _time_steps(torch, pm, dr, policy)[0]
        del dr
    del pm, csr
    torch.cuda.empty_cache()
    for grid in NCCL_TIMED_GRIDS:
        ranks = launch(_nccl_step_rank, grid[0] * grid[1], "nccl", "cuda",
                       args=(grid, seed, NCCL_TIMED_POLICIES,
                             NCCL_TIMED_STEPS), timeout=RANK_TIMEOUT)
        for policy in NCCL_TIMED_POLICIES:
            ms = max(r[policy][0] for r in ranks)
            host = max(r[policy][1] for r in ranks)
            enqueue = max(r[policy][2] for r in ranks)
            profile = ranks[0][policy][3]
            seen = "rank 0's profile: not measured (no device event)"
            if profile is not None:
                seen = (f"rank 0's device busy {profile[0]:.4f} ms a step, "
                        "top: " + "; ".join(f"{k} {t:.4f} ms x{n}"
                                           for k, t, n in profile[1]))
            log(f"[nccl] {grid[0]}x{grid[1]} {policy} at U={U} I={I} F={F}, "
                f"{N_HEADLINE} ratings: {ms:.4f} ms a step (CUDA events "
                f"over {NCCL_TIMED_STEPS} steps, the slowest rank), "
                f"{host:.4f} ms by the host clock, the host enqueueing "
                f"{enqueue:.4f} ms a step, {U / ms * 1e3:.4g} user "
                f"updates/s; one card's fused step {one[policy]:.4f} ms "
                f"({U / one[policy] * 1e3:.4g}/s); {seen}; each card "
                f"{card}")
        if ranks[0]["dT"] is not None:
            # Each turn's time on the slowest rank.
            n_bytes, turns = ranks[0]["dT"]
            t = [max(r["dT"][1][k] for r in ranks) for k in range(len(turns))]
            log(f"[nccl] {grid[0]}x{grid[1]}: the dT SUM over dp, "
                f"{n_bytes / 1e6:.2f} MB, ms a SUM in turns (20 SUMs a turn "
                f"between CUDA events, the slowest rank): median "
                f"{statistics.median(t):.4f} ("
                + ", ".join(f"{x:.4f}" for x in t) + f"); each card {card}")


def phase_shard_nccl(torch, dev, seed: int, workdir: Path, card: str):
    """``--nccl``, on a host of NCCL_RANKS cards: the sharded step's time
    at the headline shape (``_nccl_timing``), phase 10 (b) and (c) under
    NCCL, one rank a card (the engine on three grids, the families on 2 x
    2), and ``mf --devices 4 --device cuda`` against ``--devices 1`` (the
    components within 1e-5)."""
    from cu2rec_torch.cli import mf

    _nccl_timing(torch, dev, seed, card)
    data = _ml1m_data(seed)
    _shard_grids(torch, dev, seed, data, card, grids=NCCL_GRIDS,
                 backend="nccl")
    _shard_families(torch, dev, seed, data, card, grid=(2, 2),
                    backend="nccl")
    paths = _family_csvs(seed, workdir)
    cfg = workdir / "nccl.cfg"
    cfg.write_text(f"0 20 {F} 0.05 {seed} 0.02 0.02 0.02 0.02 32 10 2 "
                   "0.2\n")
    comps = {}
    for n in (1, NCCL_RANKS):
        out = workdir / f"nccl_out{n}"
        t0 = time.perf_counter()
        _capture(mf.main, ["-c", str(cfg), paths["explicit", "train"],
                           paths["explicit", "test"], "--devices", str(n),
                           "--device", "cuda", "--outdir", str(out)])
        log(f"[nccl] mf --devices {n} --device cuda: "
            f"{time.perf_counter() - t0:.1f} s wall on {card}")
        comps[n] = {c: np.loadtxt(out / f"explicit_train_f{F}_{c}.csv",
                                  delimiter=",", skiprows=1, ndmin=1)
                    for c in ("p", "q", "user_bias", "item_bias")}
    diff = max(float(np.abs(comps[NCCL_RANKS][c] - comps[1][c]).max())
               for c in comps[1])
    require(diff <= 1e-5, f"mf --devices {NCCL_RANKS} differs from "
            f"--devices 1 by {diff}")
    log(f"[nccl] mf --devices {NCCL_RANKS} against --devices 1: the "
        f"components within {diff:.3e}")


def phase_shard(torch, dev, seed: int, workdir: Path, card: str):
    """Phase 10: sharded training on the card.  Returns (kernel entries
    with their launches, K1's launches on the ranks)."""
    t0 = time.perf_counter()
    entries, launches = _shard_headline(torch, dev, seed, card)
    data = _ml1m_data(seed)
    for k, n in _shard_grids(torch, dev, seed, data, card).items():
        launches[k] = launches.get(k, 0) + n
    k1 = _shard_families(torch, dev, seed, data, card)
    _shard_cli(torch, seed, workdir, card)
    for e in entries:
        key = f"{e['shape']['dtype']}/{e['shape']['collision']}"
        e["launches"] = launches.get(key, 0)
        require(e["launches"] > 0, f"phase 10 launched no {e['name']}")
    log(f"[shard] launches {launches}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return entries, k1


# -- phase 11: sharded serving -----------------------------------------------

# (a) phase 6's catalog and waves through the daemon over n item shards on
# one card.  Against phase 6's one-device engine: recommend scores within
# rtol 1e-5 plus a response's 6-decimal rounding, items equal wherever the
# reference's scores are not tied within that; the explicit fold-in rows
# within 1e-6 (each sampled row is one shard's bits); the implicit rows
# within K1's rtol 1e-3 / atol 1e-4 (the Gramian is the shards' Grams,
# summed in another order), and so their responses' scores within 1e-3.
SERVE_SHARDS = (2, 4)
SHARD_SCORE_RTOL = 1e-5
RESPONSE_ATOL = 1e-6
# (b) the TPU package's own serving probe (experiments/serve_probe.py:
# 25-30): items, F, batch, k, fold-in iterations, ratings a new user.
PROBE_I, PROBE_F, PROBE_B, PROBE_K = 1_000_000, 64, 512, 10
PROBE_ITERS, PROBE_RATINGS = 100, 32
PROBE_SHARDS = (1, 2, 4)
# Timed fold-in batches a shard count (after one warm-up; one more runs
# under the profiler).
PROBE_FOLDS = 5
# (c) the ranks' ranking eval: the first users with a held-out list.
SERVE_EVAL_USERS = 2048


def _serve_csr(indptr, items):
    from cu2rec_torch.data.csr import CSRRatings

    return CSRRatings(indptr=np.asarray(indptr, np.int32),
                      indices=np.asarray(items, np.int32),
                      data=np.ones(len(items), np.float32), n_users=U,
                      n_items=I)


def _fold_arrays(wave):
    """(items, ratings, mask) (B, D) of a wave of fold-in requests, as the
    daemon pads them."""
    D = max(len(r["items"]) for r in wave)
    items = np.zeros((len(wave), D), np.int32)
    vals = np.zeros((len(wave), D), np.float32)
    mask = np.zeros((len(wave), D), bool)
    for b, r in enumerate(wave):
        n = len(r["items"])
        items[b, :n], vals[b, :n], mask[b, :n] = r["items"], r["ratings"], 1
    return items, vals, mask


def _same_response(got, want, rtol: float, what: str) -> None:
    """One response's items and scores against the reference's: scores
    within rtol (plus the rounding of a response), items equal wherever
    the reference's score is not tied with another within that."""
    a = np.asarray(got["scores"], np.float64)
    b = np.asarray(want["scores"], np.float64)
    require(len(a) == len(b) == len(got["items"]),
            f"{what}: {len(a)} scores, want {len(b)}")
    tol = rtol * np.abs(b) + RESPONSE_ATOL
    require(np.all(np.abs(a - b) <= tol),
            f"{what}: scores differ by {np.abs(a - b).max():.3g}")
    for j in range(len(b)):
        if (np.abs(b - b[j]) <= 2 * tol[j]).sum() == 1:
            require(got["items"][j] == want["items"][j],
                    f"{what}: item {j} is {got['items'][j]}, want "
                    f"{want['items'][j]}")


def _same_waves(resp, ctx, label: str) -> None:
    """The responses to phase 6's three waves against phase 6's: every
    recommend and implicit fold-in.  An explicit fold-in's rows depend on
    the batch slot the daemon gives the request (its sample stream keys on
    the slot), and so on how the wave's requests fell into batches: each
    must hold 10 finite-scored unrated items (``_same_explicit`` holds the
    wave's rows, in one batch, against one device's)."""
    waves, want = ctx["waves"], ctx["resp"]
    errors = [r for r in resp.values() if "error" in r]
    require(not errors, f"{label}: error responses: {errors[:3]}")
    got_rec, want_rec = resp["rec"]["results"], want["rec"]["results"]
    require(len(got_rec) == len(want_rec), f"{label}: recommend results")
    for b, (g, w) in enumerate(zip(got_rec, want_rec)):
        _same_response(g, w, SHARD_SCORE_RTOL, f"{label} recommend {b}")
    for req in waves[1]:
        r = resp[req["id"]]
        require(len(r["items"]) == 10 and np.all(np.isfinite(r["scores"]))
                and not set(r["items"]) & set(req["items"]),
                f"{label} {req['id']}: wrong items")
    for req in waves[2]:
        _same_response(resp[req["id"]], want[req["id"]], RTOL,
                       f"{label} {req['id']}")


def _same_explicit(ref, engine, wave, label: str) -> None:
    """The explicit fold-in wave in one batch (phase 6's 100 iterations)
    through ``engine`` against the one-device ``ref``: one K0c launch each,
    the same rows within 1e-6 (each sampled row is one shard's bits), then
    the same recommends."""
    from cu2rec_torch.ops import cuda_foldin
    from cu2rec_torch.utils.config import Config

    cfg = Config(n_factors=F, total_iterations=100, is_train=False)
    items, vals, mask = _fold_arrays(wave)
    n0 = cuda_foldin.LAUNCHES
    (p, ub), (p0, ub0) = (e.fold_in(items, vals, mask, cfg)
                          for e in (engine, ref))
    require(cuda_foldin.LAUNCHES - n0 == 2, f"{label}: an explicit fold-in "
            f"batch is not one foldin launch ({cuda_foldin.LAUNCHES - n0} "
            "for two)")
    err = max(np.abs(p - p0).max(), np.abs(ub - ub0).max())
    require(err <= 1e-6, f"{label}: explicit fold-in rows differ by {err}")
    got, want = (e.recommend(p0, ub0, items, mask, k=10)
                 for e in (engine, ref))
    for b in range(len(wave)):
        _same_response({"items": got[1][b].tolist(), "scores": got[0][b]},
                       {"items": want[1][b].tolist(), "scores": want[0][b]},
                       SHARD_SCORE_RTOL, f"{label} explicit {b}")


def _daemon_waves(engine, ctx, label: str):
    """Phase 6's waves through a ``ServingDaemon`` over ``engine`` with
    phase 6's settings (20 ms window, the ladder warmed to 512 x 64), no
    profiler: (responses, wave latencies, requests/s, K1, K0c and K4
    launches by wave, the whole run's (K1, K0c, K4) launches, warm-up
    seconds)."""
    from cu2rec_torch.serve.daemon import ServingDaemon, run_stdio
    from cu2rec_torch.utils.config import Config

    cfg = Config(n_factors=F, total_iterations=100, is_train=False)
    daemon = ServingDaemon(engine, train_csr=_serve_csr(ctx["indptr"],
                                                        ctx["train_items"]),
                           cfg=cfg, max_batch=512, window_ms=20.0,
                           default_k=10, completion_workers=4)
    n0 = _launch_counts()
    t0 = time.perf_counter()
    daemon.warm(max_batch=512, max_width=64, ks=(10,))
    warm_s = time.perf_counter() - t0
    out = _ResponseOutput()
    inp = _WaveInput(ctx["waves"], out, _launch_counts, None, None)
    require(run_stdio(daemon, inp, out) == 0, f"{label}: the daemon failed")
    per_wave = _wave_launches(inp, label)
    lat, rps = _wave_times(ctx["waves"], inp, out)
    run = tuple(b - a for a, b in zip(n0, _launch_counts()))
    return out.resp, lat, rps, per_wave, run, warm_s


def _headline_shards(torch, ctx, card: str) -> int:
    """Phase 11 (a): phase 6's waves over SERVE_SHARDS item shards on one
    card, each response against phase 6's one-device engine, the implicit
    rows against a one-device engine's.  Returns K1's and K4's
    launches."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.serve.engine import ServingEngine, ShardedServingEngine

    model = model_from_numpy(ctx["tables"], device="cuda")
    items, vals, mask = _fold_arrays(ctx["waves"][2])
    ref = ServingEngine(model, device="cuda")
    ref_rows, _ = ref.fold_in_implicit(items, vals, mask, 40.0, 0.1)
    lat6 = ctx["lat"]
    k1 = k4 = 0
    for n in SERVE_SHARDS:
        engine = ShardedServingEngine(model, devices=["cuda:0"] * n)
        resp, lat, rps, per_wave, launches, warm_s = _daemon_waves(
            engine, ctx, f"{n} shards")
        k1 += launches[0]
        k4 += launches[2]
        _same_waves(resp, ctx, f"{n} shards")
        _same_explicit(ref, engine, ctx["waves"][1], f"{n} shards")
        rows, _ = engine.fold_in_implicit(items, vals, mask, 40.0, 0.1)
        err = np.abs(rows - ref_rows) - RTOL * np.abs(ref_rows)
        require(err.max() <= ATOL, f"{n} shards: implicit rows differ from "
                f"one device by {np.abs(rows - ref_rows).max():.3g}")
        log(f"[shard-serve] {n} item shards on one card ({I} items, F={F}): "
            f"recommend {lat[0] * 1e3:.1f} ms, explicit fold-in "
            f"{lat[1] * 1e3:.1f} ms, implicit fold-in {lat[2] * 1e3:.1f} ms "
            f"a wave, {rps:.1f} requests/s (phase 6, one shard: "
            f"{lat6[0] * 1e3:.1f} / {lat6[1] * 1e3:.1f} / "
            f"{lat6[2] * 1e3:.1f} ms, {ctx['rps']:.1f} requests/s); warm-up "
            f"{warm_s:.1f} s; ridge_cholesky {per_wave[0]}, foldin "
            f"{per_wave[1]}, gather_gram {per_wave[2]} by wave, {launches} "
            f"(ridge_cholesky, foldin, gather_gram) in the run; the "
            f"recommends within rtol {SHARD_SCORE_RTOL:g} "
            f"and the implicit fold-ins within {RTOL:g} of phase 6's, the "
            f"explicit wave's rows within 1e-6 of one device's in one "
            f"batch, the implicit rows within "
            f"{np.abs(rows - ref_rows).max():.3g}; {card}")
        del engine
    torch.cuda.empty_cache()
    return k1, k4


# The host stages of a fold-in batch, in the order it runs them (see
# _fold_stages).
FOLD_STAGES = ("pack", "copy in", "init", "assemble", "launch", "copy out")


def _fold_stages(eng, fold_args, cfg, reps: int) -> list:
    """``reps`` batches of ``eng.fold_in(*fold_args, cfg)``, each a dict of
    host ms: its ``total`` (to the rows on the host) and each of
    FOLD_STAGES, from timers around the engine's methods (those of this
    tree or of an older one):
      pack: ``fold_in_padded`` outside the others (the request onto the
        host, the range check);
      copy in: ``_upload``, and ``_fold_in`` outside ``_rows`` and the
        kernel's wrapper (where an older tree copies the arrays);
      init: ``_default_init`` (the draw and its copy);
      assemble: ``_rows`` (several shards);
      launch: ``cuda_foldin.fold_in_cuda`` (its checks and the launch);
      copy out: ``fold_in`` outside ``fold_in_padded`` (the copy back,
        waiting for the card)."""
    from cu2rec_torch.ops import cuda_foldin

    spent: dict = {}

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
        return run

    names = [n for n in ("fold_in_padded", "_default_init", "_upload",
                         "_fold_in", "_rows") if hasattr(eng, n)]
    kernel = cuda_foldin.fold_in_cuda
    for n in names:
        setattr(eng, n, timed(n, getattr(eng, n)))
    cuda_foldin.fold_in_cuda = timed("launch", kernel)
    batches = []
    try:
        for _ in range(reps):
            spent.clear()
            t0 = time.perf_counter()
            eng.fold_in(*fold_args, cfg)
            total = time.perf_counter() - t0
            g = spent.get
            stages = {
                "pack": g("fold_in_padded", 0) - g("_default_init", 0)
                - g("_upload", 0) - g("_fold_in", 0),
                "copy in": g("_upload", 0) + g("_fold_in", 0)
                - g("_rows", 0) - g("launch", 0),
                "init": g("_default_init", 0), "assemble": g("_rows", 0),
                "launch": g("launch", 0),
                "copy out": total - g("fold_in_padded", 0)}
            batches.append({"total": total * 1e3,
                            **{k: v * 1e3 for k, v in stages.items()}})
    finally:
        for n in names:
            delattr(eng, n)
        cuda_foldin.fold_in_cuda = kernel
    return batches


def _probe_catalog(torch, seed: int):
    """The probe shape's random tables (from the seed), its model on the
    card, a fold-in batch of PROBE_B users x PROBE_RATINGS ratings (ids,
    ratings, a full mask) and its config."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.utils.config import Config

    rng = np.random.default_rng(seed + 11)
    tables = {
        "p": np.zeros((8, PROBE_F), np.float32),
        "q": rng.normal(0, 0.1, (PROBE_I, PROBE_F)).astype(np.float32),
        "user_bias": np.zeros(8, np.float32),
        "item_bias": rng.normal(0, 0.3, PROBE_I).astype(np.float32),
        "global_bias": np.array([3.5], np.float32),
    }
    fold = (rng.integers(0, PROBE_I, (PROBE_B, PROBE_RATINGS)).astype(
                np.int32),
            rng.uniform(1, 5, (PROBE_B, PROBE_RATINGS)).astype(np.float32),
            np.ones((PROBE_B, PROBE_RATINGS), bool))
    cfg = Config(total_iterations=PROBE_ITERS, learning_rate=0.05,
                 n_factors=PROBE_F)
    return tables, model_from_numpy(tables, device="cuda"), fold, cfg


def _probe_fold(torch, eng, fold, cfg) -> dict:
    """A probe fold-in batch on ``eng``: the first (cold: the engine's
    first batch of this size, the process's host buffers not yet pooled
    where it is the first engine), PROBE_FOLDS timed batches
    (``_fold_stages``; one K0c launch each, or the check fails), and one
    more under the profiler: the cold batch's and the batches' host ms,
    each stage's median, the device busy ms and its top kernels."""
    from cu2rec_torch.ops import cuda_foldin

    cuda_foldin._load()            # the cold batch times no library load
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.fold_in(*fold, cfg)
    cold_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    n0 = cuda_foldin.LAUNCHES
    batches = _fold_stages(eng, fold, cfg, PROBE_FOLDS)
    launched = cuda_foldin.LAUNCHES - n0
    require(launched == PROBE_FOLDS, f"probe, {eng.n_ip} shards: "
            f"{launched} foldin launches for {PROBE_FOLDS} fold-in batches")
    prof, host_s = _profiled(torch, lambda: eng.fold_in(*fold, cfg),
                             lambda: _new_profile(torch))
    busy_s, top = _device_breakdown(torch, prof, top=4)
    return {"cold_ms": cold_ms, "ms": [b["total"] for b in batches],
            "stages": {k: statistics.median(b[k] for b in batches)
                       for k in FOLD_STAGES},
            "device_ms": busy_s * 1e3, "profiled_host_ms": host_s * 1e3,
            "top": top}


def _probe_fold_stages(torch, seed: int) -> dict:
    """``_probe_fold`` over PROBE_SHARDS item shards on the card, by shard
    count (a run of this tree or, through experiments/foldin_stages.py,
    of an older one)."""
    from cu2rec_torch.serve.engine import ShardedServingEngine

    _, model, fold, cfg = _probe_catalog(torch, seed)
    out = {}
    for n in PROBE_SHARDS:
        eng = ShardedServingEngine(model, devices=["cuda:0"] * n)
        out[str(n)] = {k: v for k, v in _probe_fold(torch, eng, fold,
                                                    cfg).items()
                       if k != "top"}
        del eng
    return out


def _probe_shards(torch, seed: int, card: str) -> None:
    """Phase 11 (b): the TPU package's serving probe shape over
    PROBE_SHARDS item shards on the card: recommend users/s
    (``bench_qps``), a fold-in batch's time (the median of PROBE_FOLDS, one
    K0c launch each), the host time of each of its stages and its device
    time under the profiler, 32 users' top-10 against a float64
    reference."""
    from cu2rec_torch.serve.engine import ShardedServingEngine

    tables, model, fold, cfg = _probe_catalog(torch, seed)
    rng = np.random.default_rng(seed + 12)
    p = rng.normal(0, 1.0, (32, PROBE_F)).astype(np.float32)
    rated = rng.integers(0, PROBE_I, (32, PROBE_RATINGS)).astype(np.int32)
    ref = (tables["q"].astype(np.float64) @ p.T.astype(np.float64)).T \
        + 3.5 + tables["item_bias"].astype(np.float64)[None, :]
    ref[np.arange(32)[:, None], rated] = -np.inf
    top = -np.sort(-np.partition(ref, -PROBE_K, axis=1)[:, -PROBE_K:],
                   axis=1)
    tol = 1e-3 * np.maximum(1.0, np.abs(top).max(axis=1))
    b_rows = rng.normal(0, 1.0 / PROBE_F, (PROBE_B, PROBE_F)).astype(
        np.float32)
    b_rated = rng.integers(0, PROBE_I, (PROBE_B, 32)).astype(np.int32)
    for n in PROBE_SHARDS:
        eng = ShardedServingEngine(model, devices=["cuda:0"] * n)
        vals, ids = eng.recommend(p, np.zeros(32, np.float32), rated,
                                  np.ones_like(rated, bool), k=PROBE_K)
        got = ref[np.arange(32)[:, None], ids]
        require(np.all(np.isfinite(got)) and np.all(np.isfinite(vals)),
                f"probe, {n} shards: a rated item or a non-finite score")
        require(np.all(np.abs(got - vals).max(axis=1) <= tol)
                and np.all(np.abs(top - vals).max(axis=1) <= tol),
                f"probe, {n} shards: not the float64 reference's top-10")
        torch.cuda.reset_peak_memory_stats()
        qps = eng.bench_qps(batch_size=PROBE_B, k=PROBE_K, n_batches=20,
                            seed=seed)
        peak = torch.cuda.max_memory_allocated() / 2**20

        def batch():
            eng.recommend_padded(b_rows, np.zeros(PROBE_B, np.float32),
                                 b_rated, np.ones_like(b_rated, bool),
                                 k=PROBE_K)
            torch.cuda.synchronize()

        prof, host_s = _profiled(torch, batch, lambda: _new_profile(torch))
        busy_s, kernels = _device_breakdown(torch, prof, top=4)
        f = _probe_fold(torch, eng, fold, cfg)
        fold_ms = statistics.median(f["ms"])
        log(f"[shard-serve] probe shape, {n} item shard(s): fold-in batch "
            f"of {PROBE_B} x {PROBE_RATINGS} ratings, {PROBE_ITERS} "
            f"iterations, by the host clock to the rows on the host: median "
            f"{fold_ms:.3f} ms of {PROBE_FOLDS} ({min(f['ms']):.3f}-"
            f"{max(f['ms']):.3f}), the engine's first {f['cold_ms']:.3f} "
            "ms; one foldin launch a batch; host ms by "
            "stage (medians): " + ", ".join(
                f"{k} {v:.3f}" for k, v in f["stages"].items())
            + f"; under the profiler: device busy {f['device_ms']:.3f} ms "
            f"of {f['profiled_host_ms']:.3f} ms "
            f"({f['device_ms'] / f['profiled_host_ms']:.1%}), top kernels: "
            + "; ".join(f"{k[:48]} {ms:.3f} ms x{c}"
                        for k, ms, c in f["top"]) + f"; {card}")
        log(f"[shard-serve] probe shape ({PROBE_I} items, F={PROBE_F}, "
            f"batch {PROBE_B}, k={PROBE_K}) over {n} item shard(s) on one "
            f"card: recommend {qps:.1f} users/s (20 batches, host clock "
            f"to a synchronize), fold-in batch of {PROBE_B} x "
            f"{PROBE_RATINGS} ratings, {PROBE_ITERS} iterations: "
            f"{fold_ms:.1f} ms ({PROBE_B / fold_ms * 1e3:.1f} users/s); "
            f"peak {peak:.0f} MiB while recommending; one recommend batch "
            f"under the profiler: device busy {busy_s * 1e3:.3f} ms of "
            f"{host_s * 1e3:.3f} ms, top kernels: " + "; ".join(
                f"{k[:48]} {ms:.3f} ms x{c}" for k, ms, c in kernels)
            + f"; 32 users' top-10 within the float64 reference; {card}")
        del eng
    del model
    torch.cuda.empty_cache()


def _eval_split(ctx, one):
    """A held-out list for the first SERVE_EVAL_USERS users: the
    one-device engine's top 5 for the user and 5 random items, so that
    recall and NDCG are far from 0 and move with the ranking."""
    from cu2rec_torch.data.csr import CSRRatings

    users = np.arange(SERVE_EVAL_USERS)
    csr = _serve_csr(ctx["indptr"], ctx["train_items"])
    _, ids = one.recommend_known(users, csr, k=10)
    rng = np.random.default_rng(7)
    held = np.concatenate([ids[:, :5], rng.integers(0, I, (len(users), 5))],
                          axis=1).astype(np.int32)
    indptr = np.zeros(U + 1, np.int32)
    indptr[1:SERVE_EVAL_USERS + 1] = np.arange(1, SERVE_EVAL_USERS + 1) * 10
    indptr[SERVE_EVAL_USERS + 1:] = SERVE_EVAL_USERS * 10
    return CSRRatings(indptr=indptr, indices=held.reshape(-1),
                      data=np.ones(held.size, np.float32), n_users=U,
                      n_items=I)


def _serve_rank_job(seed: int, test_args):
    """A rank of an item-sharded grid (1 x world) on the card: the
    rank-mode engine over phase 6's catalog (the recommend wave, the
    implicit and explicit fold-in waves, each run once and then timed to a
    synchronize) and ``sharded_ranking_eval``; K1's and K0c's launches on
    the rank."""
    import torch

    from cu2rec_torch.data.csr import CSRRatings
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.ops import cuda_foldin, cuda_linalg
    from cu2rec_torch.parallel.distributed import barrier
    from cu2rec_torch.parallel.serving import sharded_ranking_eval
    from cu2rec_torch.parallel.sharded import make_mesh
    from cu2rec_torch.serve.engine import ShardedServingEngine
    from cu2rec_torch.utils.config import Config

    world = torch.distributed.get_world_size()
    mesh = make_mesh(1, world)
    tables, users, items, _ = _serve_data(seed)
    model = model_from_numpy(tables, device=mesh.device)
    csr = _serve_csr(np.searchsorted(users, np.arange(U + 1)), items)
    rec_users, waves = _requests(np.random.default_rng(seed + 1))
    eng = ShardedServingEngine(model, mesh=mesh)
    cfg = Config(n_factors=F, total_iterations=100, is_train=False)
    ops = {
        "recommend": lambda: eng.recommend_known(rec_users, csr, k=10),
        "explicit": lambda: eng.fold_in(*_fold_arrays(waves[1]), cfg),
        "implicit": lambda: eng.fold_in_implicit(*_fold_arrays(waves[2]),
                                                 40.0, 0.1)[0],
    }
    out, ms = {}, {}
    n0, f0 = cuda_linalg.LAUNCHES, cuda_foldin.LAUNCHES
    for name, op in ops.items():
        op()
        barrier()
        t0 = time.perf_counter()
        out[name] = op()
        ms[name] = (time.perf_counter() - t0) * 1e3
    out["k1"] = cuda_linalg.LAUNCHES - n0
    out["k0c"] = cuda_foldin.LAUNCHES - f0
    out["eval"] = sharded_ranking_eval(mesh, model, csr,
                                       CSRRatings(*test_args), k=10,
                                       max_users=SERVE_EVAL_USERS)
    out["ms"] = ms
    return out


def _rank_shards(torch, seed: int, ctx, card: str, world: int = 2,
                 backend: str = "gloo") -> int:
    """Phase 11 (c): ``world`` ranks, a shard each (gloo ranks sharing the
    card, or NCCL ranks a card each), against the one-process shards: the
    ranks bit-equal, the recommends and fold-ins within phase 11 (a)'s
    tolerances, ``sharded_ranking_eval`` equal to ``ranking_eval`` within
    1e-6, each explicit fold-in one K0c launch a rank.  Returns (K1's
    launches on the ranks, K0c's)."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.parallel.distributed import launch
    from cu2rec_torch.serve.engine import ShardedServingEngine
    from cu2rec_torch.serve.recommend import ranking_eval
    from cu2rec_torch.utils.config import Config

    model = model_from_numpy(ctx["tables"], device="cuda")
    devices = (["cuda:0"] * world if backend == "gloo"
               else [f"cuda:{r}" for r in range(world)])
    one = ShardedServingEngine(model, devices=devices)
    test = _eval_split(ctx, one)
    t0 = time.perf_counter()
    ranks = launch(_serve_rank_job, world, backend, "cuda", args=(
        seed, (test.indptr, test.indices, test.data, U, I)),
        timeout=RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    for n, r in enumerate(ranks[1:], 1):
        for key in ("recommend", "explicit", "implicit"):
            for a, b in zip(ranks[0][key], r[key]):
                require(np.array_equal(a, b), f"rank {n}'s {key} differs "
                        "from rank 0's")
        require(r["eval"] == ranks[0]["eval"], "the ranks' evals differ")
    r0 = ranks[0]
    csr = _serve_csr(ctx["indptr"], ctx["train_items"])
    rec_users = np.asarray([int(u) for u in ctx["waves"][0][0]["users"]])
    v, i = one.recommend_known(rec_users, csr, k=10)
    for b in range(len(rec_users)):
        _same_response({"items": r0["recommend"][1][b].tolist(),
                        "scores": r0["recommend"][0][b]},
                       {"items": i[b].tolist(), "scores": v[b]},
                       SHARD_SCORE_RTOL, f"{backend} ranks recommend {b}")
    cfg = Config(n_factors=F, total_iterations=100, is_train=False)
    want_p, want_ub = one.fold_in(*_fold_arrays(ctx["waves"][1]), cfg)
    err = max(np.abs(r0["explicit"][0] - want_p).max(),
              np.abs(r0["explicit"][1] - want_ub).max())
    require(err <= 1e-6, f"{backend} ranks: explicit fold-in rows differ "
            f"by {err:.3g}")
    want_rows = one.fold_in_implicit(*_fold_arrays(ctx["waves"][2]), 40.0,
                                     0.1)[0]
    err = np.abs(r0["implicit"] - want_rows) - RTOL * np.abs(want_rows)
    require(err.max() <= ATOL, f"{backend} ranks: implicit rows differ by "
            f"{np.abs(r0['implicit'] - want_rows).max():.3g}")
    want = ranking_eval(model, csr, test, k=10, max_users=SERVE_EVAL_USERS)
    for m in ("recall", "ndcg"):
        require(abs(r0["eval"][m] - want[m]) < 1e-6,
                f"{backend} ranks: sharded {m} {r0['eval'][m]} against "
                f"ranking_eval's {want[m]}")
    require(all(r["k1"] > 0 for r in ranks), "a rank launched no K1")
    require(all(r["k0c"] == 2 for r in ranks), "a rank's two explicit "
            "fold-ins were not two foldin launches: "
            f"{[r['k0c'] for r in ranks]}")
    times = {k: max(r["ms"][k] for r in ranks) for k in ranks[0]["ms"]}
    what = ("gloo stages each CUDA all_reduce through the host: a check, "
            "not a timing of the card" if backend == "gloo"
            else "one rank a card")
    log(f"[shard-serve] {world} {backend} ranks, a shard each: recommend "
        f"{times['recommend']:.1f} ms (512 users), explicit fold-in "
        f"{times['explicit']:.1f} ms (256 users, 100 iterations), implicit "
        f"{times['implicit']:.1f} ms (256 users), the slowest rank by the "
        f"host clock ({what}); {wall:.1f} s with the ranks' start; "
        f"recall@10 {r0['eval']['recall']:.6f}, NDCG@10 "
        f"{r0['eval']['ndcg']:.6f} = ranking_eval's; K1 "
        f"{[r['k1'] for r in ranks]}, foldin {[r['k0c'] for r in ranks]} by "
        f"rank; {card}")
    return sum(r["k1"] for r in ranks), sum(r["k0c"] for r in ranks)


def _serve_cli_shards(torch) -> None:
    """Phase 11 (d): ``serve --devices 2 --device cuda`` on a host of fewer
    cards raises and names both counts."""
    from cu2rec_torch.cli.serve import main as serve_main

    n = torch.cuda.device_count()
    if n >= 2:
        return
    try:
        serve_main(["--checkpoint", "absent.npz", "--devices", "2",
                    "--device", "cuda"])
    except RuntimeError as e:
        require("--devices 2" in str(e) and f"has {n}" in str(e),
                f"serve --devices 2: the error names no counts: {e}")
        log(f"[shard-serve] serve --devices 2 --device cuda on {n} card(s) "
            f"raises: {e}")
    else:
        raise SmokeFailure("serve --devices 2 --device cuda ran on a host "
                           f"of {n} card(s)")


def phase_shard_serve(torch, seed: int, ctx, card: str) -> dict:
    """Phase 11: sharded serving on one card.  Returns K1's, K0c's and
    K4's launches (K4's in this process, the ranks' not counted)."""
    from cu2rec_torch.ops import cuda_foldin

    t0 = time.perf_counter()
    cuda_foldin.LAUNCHES = 0
    k1, k4 = _headline_shards(torch, ctx, card)
    _probe_shards(torch, seed, card)
    k0c = cuda_foldin.LAUNCHES
    ranks = _rank_shards(torch, seed, ctx, card)
    _serve_cli_shards(torch)
    launches = {"ridge_cholesky": k1 + ranks[0], "foldin": k0c + ranks[1],
                "gather_gram": k4}
    log(f"[shard-serve] launches {launches}; the phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def _serve_cli_waves(data, seed: int, n: int | None, card: str):
    """``--nccl``: phase 6's waves through ``serve --devices n --device
    cuda`` (n None: no ``--devices``, an item shard on every card) over
    ``_make_data``'s files, no profiler: the context of ``_same_waves``."""
    from cu2rec_torch.cli.serve import main as serve_main

    tables, ckpt, train, indptr, train_items = data
    _, waves = _requests(np.random.default_rng(seed + 1))
    out = _ResponseOutput()
    inp = _WaveInput(waves, out, _launch_counts, None, None)
    saved = sys.stdin, sys.stdout
    sys.stdin, sys.stdout = inp, out
    t0 = time.perf_counter()
    try:
        rc = serve_main(["--checkpoint", ckpt, "--train", train, "--device",
                         "cuda", "--window-ms", "20", "--warm-batch", "512",
                         "--warm-width", "64"]
                        + ([] if n is None else ["--devices", str(n)]))
    finally:
        sys.stdin, sys.stdout = saved
    what = "serve" if n is None else f"serve --devices {n}"
    require(rc == 0, f"{what} exited with {rc}")
    lat, rps = _wave_times(waves, inp, out)
    log(f"[nccl] {what} --device cuda ({out.resp['stats']['n_shards']} "
        f"shards): recommend "
        f"{lat[0] * 1e3:.1f} ms, explicit fold-in {lat[1] * 1e3:.1f} ms, "
        f"implicit fold-in {lat[2] * 1e3:.1f} ms a wave, {rps:.1f} "
        f"requests/s; {time.perf_counter() - t0:.1f} s with the model's "
        f"load and the warm-up; each card {card}")
    return {"tables": tables, "indptr": indptr, "train_items": train_items,
            "waves": waves, "resp": out.resp, "lat": lat, "rps": rps}


def phase_shard_serve_nccl(torch, seed: int, workdir: Path, card: str):
    """``--nccl``'s phase 11: phase 6's waves through ``serve --devices 1``
    and ``serve`` with no ``--devices``, which must shard over every card
    (every response of the four cards against the one card's), and the
    rank-mode engine on NCCL_RANKS NCCL ranks, a card each, against the
    one-process shards over the four cards."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.serve.engine import ServingEngine, ShardedServingEngine

    data = _make_data(seed, workdir)
    one = _serve_cli_waves(data, seed, 1, card)
    four = _serve_cli_waves(data, seed, None, card)
    n_cards = torch.cuda.device_count()
    for run, want in ((one, 1), (four, n_cards)):
        got = run["resp"]["stats"]["n_shards"]
        require(got == want, f"serve on {n_cards} cards: {got} shards, "
                f"want {want}")
    _same_waves(four["resp"], one, f"serve on {n_cards} cards")
    model = model_from_numpy(one["tables"], device="cuda")
    _same_explicit(ServingEngine(model, device="cuda"), ShardedServingEngine(
        model, devices=[f"cuda:{r}" for r in range(NCCL_RANKS)]),
        one["waves"][1], f"{NCCL_RANKS} cards")
    _rank_shards(torch, seed, one, card, world=NCCL_RANKS, backend="nccl")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl", action="store_true",
                    help=f"on a host of {NCCL_RANKS} cards: only the build "
                    "and the sharded paths under NCCL, one rank a card")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (HERE / "cu2rec_torch" / "__init__.py").exists():
        print("chip_smoke: run from a checkout of the repository (the "
              "cu2rec_torch package is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    name, count, smi = phase_device(torch)
    registers = phase_build()
    if args.nccl:
        require(count >= NCCL_RANKS, f"--nccl needs {NCCL_RANKS} cards, "
                f"this host has {count}")
        with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
            phase_shard_nccl(torch, dev, args.seed, Path(tmp), smi)
            phase_shard_serve_nccl(torch, args.seed, Path(tmp), smi)
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}), flush=True)
        return 0
    kernels = phase_kernels(torch, dev)
    kernels += phase_train_kernels(torch, dev, args.seed)
    kernels += phase_variant_kernels(torch, dev, args.seed)
    kernels += phase_foldin_kernel(torch, dev, args.seed, smi)
    kernels += phase_draw_kernel(torch, dev, args.seed, smi)
    by_name = {k["name"]: k for k in kernels}
    for k in kernels:
        k["registers"] = registers[Path(k["source"]).stem]
    # The main paths, each with the launch counts set to 0 just before it
    # and read just after it (K5's and the draw counters by ``_draws``).
    draws = {}
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        with _draws(draws, "train"):
            trained, out, f32_rmse = phase_train(torch, args.seed,
                                                 Path(tmp), smi)
        with _draws(draws, "predict"):
            predicted = phase_predict(args.seed, Path(tmp), out, smi)
        # Phase 9's entry points, on phase 5's CSVs.
        with _draws(draws, "variants"):
            variants, extras = phase_variants(torch, args.seed, Path(tmp),
                                              smi, f32_rmse)
    probed = phase_probes()
    with _draws(draws, "serve"):
        served, serve_ctx = phase_serve(torch, args.seed, smi)
    with _draws(draws, "families"):
        families, measured = phase_families(torch, dev, args.seed, smi)
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        with _draws(draws, "pipeline"):
            piped, pipeline = phase_pipeline(args.seed, Path(tmp), smi)
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        with _draws(draws, "shard"):
            sharded, shard_k1 = phase_shard(torch, dev, args.seed,
                                            Path(tmp), smi)
    with _draws(draws, "shard_serve"):
        shard_served = phase_shard_serve(torch, args.seed, serve_ctx, smi)
    # K5 draws each card model whose tables have 16 entries or more, one
    # launch a model (the transforms were checked in phase 4); the training
    # paths draw every model on the card.  A card model's CPU draw is a
    # fold-in's (its one-entry bias), counted in predict and variants.
    for label, n in draws.items():
        require(n["normal_draw"] == n["card_draws"],
                f"{label}: {n['normal_draw']} K5 launches for "
                f"{n['card_draws']} card draws")
    for label in ("train", "variants", "families", "pipeline"):
        require(draws[label]["card_draws"] > 0,
                f"{label} drew no model with K5: {draws[label]}")
    for label in ("train", "families", "pipeline"):
        require(draws[label]["cpu_draws"] == 0,
                f"{label} drew a card model on the CPU: {draws[label]}")
    for k in sharded:  # the registers of the variant's own instances
        tag = f"<128,{k['shape']['dtype']}"
        k["registers"] = {fn: r for fn, r in registers["sgd_sharded"].items()
                          if tag in fn or "apply" in fn}
    kernels += sharded
    by_name["sgd_step"]["launches"] = trained["sgd_step"] + \
        predicted["explicit"] + piped["sgd_step"]
    by_name["sgd_step"]["pipeline"] = pipeline
    by_name["eval_error"]["launches"] = trained["eval_error"] + \
        families["eval_error"] + piped["eval_error"]
    by_name["ridge_cholesky"]["launches"] = served["ridge_cholesky"] \
        + predicted["implicit"] \
        + families["ridge_cholesky"]
    by_name["ridge_cholesky"]["families"] = measured
    for key, n in variants.items():
        if f"sgd_step/{key}" in by_name:
            by_name[f"sgd_step/{key}"]["launches"] = n
    by_name["eval_error/bfloat16"]["launches"] = \
        variants["eval_error/bfloat16"]
    by_name["ridge_cholesky"]["launches"] += variants["ridge_cholesky"] \
        + shard_k1 + shard_served["ridge_cholesky"]
    by_name["foldin"]["launches"] = served["foldin"] + shard_served["foldin"]
    by_name["sgd_step"]["variants"] = extras
    by_name["row_gather"]["launches"] = probed["row_gather"]
    by_name["smem_gather"]["launches"] = probed["smem_gather"]
    by_name["normal_draw"]["launches"] = sum(
        n["normal_draw"] for n in draws.values())
    by_name["normal_draw"]["draws"] = draws
    k6 = measured["bpr"]["k6"]
    k6["launches"] = families["bpr_step"]
    k6["registers"] = registers["bpr_step"]
    kernels.append(k6)
    kernels.append(_gram_entry(measured, served["gather_gram"]
                               + predicted["implicit_gram"]
                               + families["gather_gram"]
                               + shard_served["gather_gram"],
                               registers["gather_gram"]))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
