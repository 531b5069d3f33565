#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It fails (exit code != 0, no result line)
when no CUDA device is present or the package is missing.  Phases, each
fatal on failure:

1. device: the card's name, count and power limit; float32 matmuls in full
   float32 (TF32 off);
2. build: every CUDA kernel of the serving path from ``cu2rec_torch/csrc``
   with nvcc, and its ``-Xptxas -v`` report;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it (and the edge shapes), with its
   time, the plain version's, the library call's and the bound;
4. serve: the ``serve`` CLI over stdio at ML-20M scale (138,000 users,
   27,000 items, F=100, 1,000,000 train ratings; random tables from
   ``--seed``): one recommend of 512 known users, 256 explicit fold-ins,
   256 implicit fold-ins and a stats request, each checked (k items, rated
   items excluded, scores against a float64 reference for a sample), with
   the kernels' launch counts read across the run.  Each wave is timed
   without a profiler, then sent again under ``torch.profiler``; that
   replay gives the card's busy time and its top kernels.

It prints the kernels' JSON line, then the nvidia-smi name/power line, then
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and
# float32 (non-tensor-core) FLOP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Ridge-solve tolerance: float32 Cholesky of condition number < ~10.
RTOL, ATOL = 1e-3, 1e-4
SHAPES = [(7, 9), (1000, 51), (256, 100), (64, 101), (33, 301), (8, 400)]
MAIN_SHAPE = (256, 100)          # the implicit fold-in batch at F=100
U, I, F = 138_000, 27_000, 100   # bench.py's ML-20M-scale headline model
N_RATINGS = 1_000_000


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

def phase_build():
    from cu2rec_torch.csrc.build import KERNELS, build, build_log

    t0 = time.perf_counter()
    libs = build(KERNELS)
    log(f"[build] {len(libs)} kernel(s) in "
        f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")


# -- phase 3: kernels --------------------------------------------------------

def _tpu_kernel_site(rel: str, needle: str) -> str:
    """``<package>/<rel>:<line>`` of the TPU kernel this port replaces,
    found in the checkout (the TPU package is read, never imported)."""
    for path in sorted(HERE.glob(f"*/{rel}")):
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(needle):
                return f"{path.relative_to(HERE)}:{n}"
    return f"{rel} ({needle})"


def _spd(torch, B, N, seed, dev):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, N, N)).astype(np.float32)
    G = np.einsum("bik,bjk->bij", A, A) / N + \
        np.eye(N, dtype=np.float32)[None] * 0.5
    rhs = rng.normal(size=(B, N)).astype(np.float32)
    return (torch.from_numpy(G).to(dev), torch.from_numpy(rhs).to(dev))


def _time_ms(torch, fn, inputs, reps: int, warm: int = 2) -> float:
    """Mean ms per call with CUDA events, cycling through ``inputs`` (sets
    whose total exceeds the 50 MB L2, so each call reads from HBM)."""
    for r in range(warm):
        fn(*inputs[r % len(inputs)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(*inputs[r % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernels(torch, dev):
    from cu2rec_torch.ops import cuda_linalg as cl

    for B, N in SHAPES:
        G, rhs = _spd(torch, B, N, seed=N, dev=dev)
        got = cl.ridge_solve_batched_cuda(G, rhs)
        torch.cuda.synchronize()
        want = cl.ridge_solve_reference(G, rhs)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        path = "global" if cl._load().ridge_cholesky_scratch_floats(N) \
            else "shared"
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        log(f"[kernel] ridge_cholesky B={B} N={N} ({path} memory): "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} ok={ok}")
        require(ok and torch.isfinite(got).all(),
                f"ridge_cholesky disagrees with its plain version at "
                f"B={B} N={N}: max abs err {err}")

    B, N = MAIN_SHAPE
    sets = [_spd(torch, B, N, seed=1000 + s, dev=dev) for s in range(6)]
    got = cl.ridge_solve_batched_cuda(*sets[0])
    want = cl.ridge_solve_reference(*sets[0])
    err = float((got - want).abs().max())

    def library(G, rhs):
        L = torch.linalg.cholesky(G)
        return torch.cholesky_solve(rhs[..., None], L)[..., 0]

    lib_err = float((library(*sets[0]) - got).abs().max())
    require(lib_err < 1e-3, f"library solve disagrees: {lib_err}")
    ms = _time_ms(torch, cl.ridge_solve_batched_cuda, sets, reps=60)
    plain_ms = _time_ms(torch, cl.ridge_solve_reference, sets, reps=5)
    library_ms = _time_ms(torch, library, sets, reps=30)
    # A Cholesky solve of a symmetric G needs only its lower triangle.
    n_bytes = 4 * (B * N * (N + 1) // 2 + 2 * B * N)
    n_ops = B * (N ** 3 / 3 + 2 * N ** 2)
    bytes_ms = n_bytes / PEAK_BYTES_S * 1e3
    ops_ms = n_ops / PEAK_F32_FLOP_S * 1e3
    entry = {
        "name": "ridge_cholesky", "route": "cuda",
        "source": "cu2rec_torch/csrc/ridge_cholesky.cu",
        "replaces": _tpu_kernel_site("ops/pallas_linalg.py",
                                     "def _ridge_kernel"),
        "launches": None, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "shape": {"B": B, "N": N},
    }
    log(f"[kernel] ridge_cholesky B={B} N={N}: {ms:.4f} ms kernel, "
        f"{plain_ms:.3f} ms plain, {library_ms:.4f} ms library "
        f"(cholesky + cholesky_solve), bound {entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}: {n_bytes / 1e6:.2f} MB, "
        f"{n_ops / 1e6:.1f} MFLOP)")
    return [entry]


# -- phase 4: serve ----------------------------------------------------------

def _replay(wave):
    """The same requests under new ids."""
    return [dict(r, id=f"{r['id']}~prof") for r in wave]


class _WaveInput:
    """The daemon's stdin: yields one wave of request lines, then waits
    until every response of that wave is written before the next wave
    (a closed loop, so each wave is one batch).  ``probe()`` (a launch
    count) is read as each wave starts and once its responses are out.
    Each wave is timed with no profiler running; then, except for the
    last (stats) wave, its replay runs under a profiler from
    ``profile()``."""

    def __init__(self, waves, out, probe, profile):
        self.waves, self.out, self.probe = waves, out, probe
        self.profile = profile
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
            if n == len(self.waves) - 1:
                continue
            prof = self.profile()
            prof.start()
            t0 = time.perf_counter()
            yield from self._send(_replay(wave))
            prof.stop()
            self.profiles.append((prof, t0))


def _device_breakdown(torch, prof, top: int = 6):
    """(device busy seconds, [(kernel, ms, calls)] by device time) from one
    wave's profile: the union of the CUDA kernel intervals."""
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (t - s) / 1e3, n + 1)
    busy_us, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > end:
            busy_us += t - max(s, end)
            end = t
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


def _make_data(seed: int, workdir: Path):
    """Random ML-20M-scale tables and a user-sorted train CSV, from the
    seed; the tables go into an ``.npz`` through the port's
    ``save_checkpoint``."""
    from cu2rec_torch.models.state import model_from_numpy
    from cu2rec_torch.utils.checkpoint import save_checkpoint
    from cu2rec_torch.utils.config import Config

    rng = np.random.default_rng(seed)
    tables = {
        "p": rng.normal(0, 0.1, (U, F)).astype(np.float32),
        "q": rng.normal(0, 0.1, (I, F)).astype(np.float32),
        "user_bias": rng.normal(0, 0.3, U).astype(np.float32),
        "item_bias": rng.normal(0, 0.3, I).astype(np.float32),
        "global_bias": np.array([3.5], np.float32),
    }
    ckpt = save_checkpoint(str(workdir / "model.npz"),
                           model_from_numpy(tables, device="cpu"),
                           Config(n_factors=F, total_iterations=100))
    users = np.sort(np.concatenate([np.arange(U),
                                    rng.integers(0, U, N_RATINGS - U)]))
    items = rng.integers(0, I, N_RATINGS)
    ratings = rng.integers(1, 11, N_RATINGS) / 2.0
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


def phase_serve(torch, seed: int, card: str, device: str = "cuda"):
    from torch.profiler import ProfilerActivity

    from cu2rec_torch.cli.serve import main as serve_main
    from cu2rec_torch.ops import cuda_linalg

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory(prefix="cu2rec_smoke_") as tmp:
        t0 = time.perf_counter()
        tables, ckpt, train, indptr, train_items = _make_data(
            seed, Path(tmp))
        log(f"[serve] data: {U} users x {I} items, F={F}, "
            f"{N_RATINGS} train ratings ({time.perf_counter() - t0:.1f} s)")
        rec_users, waves = _requests(rng)
        out = _ResponseOutput()
        inp = _WaveInput(waves, out, lambda: cuda_linalg.LAUNCHES,
                         lambda: torch.profiler.profile(activities=[
                             ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        saved = sys.stdin, sys.stdout
        sys.stdin, sys.stdout = inp, out
        cuda_linalg.LAUNCHES = 0
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
        launches = cuda_linalg.LAUNCHES
        wall = time.perf_counter() - t0
    require(rc == 0, f"serve exited with {rc}")

    want = {r["id"] for w in waves for r in w} | {
        r["id"] for w in waves[:-1] for r in _replay(w)}
    require(want <= out.resp.keys(),
            f"missing responses: {sorted(want - out.resp.keys())[:5]}")
    errors = [r for r in out.resp.values() if "error" in r]
    require(not errors, f"error responses: {errors[:3]}")
    stats = out.resp["stats"]
    require(stats["device"].startswith("cuda"),
            f"the engine's tables are on {stats['device']}")
    per_wave = [b - a for a, b in inp.counts]
    require(per_wave[2] > 0, "ridge_cholesky was not launched by the "
            "implicit fold-ins")
    require(per_wave[0] == per_wave[1] == 0,
            "ridge_cholesky launched outside the implicit fold-ins")

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

    lat = [max(out.t_done[r["id"]] for r in w) - t
           for w, t in zip(waves[:3], inp.t_start[:3])]
    n_req = sum(len(w) for w in waves[:3])
    rps = n_req / sum(lat)
    log(f"[serve] {n_req} requests in 3 batches: recommend "
        f"{lat[0] * 1e3:.1f} ms, explicit fold-in {lat[1] * 1e3:.1f} ms, "
        f"implicit fold-in {lat[2] * 1e3:.1f} ms; p50 batch latency "
        f"{float(np.median(lat)) * 1e3:.1f} ms; {rps:.1f} requests/s "
        f"(serving waves only, no profiler; {wall:.1f} s with model load "
        f"and the profiled replays) on {card}")
    log(f"[serve] ridge_cholesky launches: {launches} in the run "
        f"(warm-up ladder and replays included), per wave {per_wave[:3]} "
        f"(recommend, explicit, implicit); stats: {json.dumps(stats)}")
    for what, (prof, t0), wave, wave_s in zip(
            ("recommend", "explicit fold-in", "implicit fold-in"),
            inp.profiles, waves, lat):
        replay_s = max(out.t_done[r["id"]] for r in _replay(wave)) - t0
        busy_s, top = _device_breakdown(torch, prof)
        require(top, f"profile of the {what} wave holds no device time")
        log(f"[profile] {what}: device busy {busy_s * 1e3:.3f} ms, "
            f"{busy_s / replay_s:.1%} of the profiled replay's "
            f"{replay_s * 1e3:.1f} ms, {busy_s / wave_s:.1%} of the "
            f"unprofiled wave's {wave_s * 1e3:.1f} ms;"
            " top kernels by device time: " + "; ".join(
                f"{k[:60]} {ms:.3f} ms x{n}" for k, ms, n in top))
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
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
    name, count, smi = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch, torch.device("cuda"))
    kernels[0]["launches"] = phase_serve(torch, args.seed, smi)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
