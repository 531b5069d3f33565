"""K5, the starting tables drawn on the card, timed against the CPU draw it
replaces, at the benchmark's model shapes.

    python -m cu2rec_torch.experiments.draw_times [--out FILE]

First the transforms: their build from torch's CPU ``randn`` (the cache
off), a load from the cache, and ``device_tables`` (the load, the upload
and the card's self-check) with K5 unbuilt and built.  Then for each
shape and dtype: ``init_model`` on the card against the same call on the
CPU (the tables compared under ``torch.equal``, a seed a shape), K5's walk
(``mt_windows_kernel``) and whole draw by CUDA events, the call's host
time to a synchronized model, the CPU draw and its upload (the path the
card replaces), the plain version on the host (up to ``PLAIN_WORDS``),
and torch's own CUDA ``randn`` of the same sizes (Philox: other numbers,
the cost of a library draw on the card).  The bound counts the tables
written, the windows written and read, and each transform's sectors
gathered, at most the whole transform.  One JSON line a record; a file
only with ``--out``.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from cu2rec_torch.experiments.common import Records
from cu2rec_torch.models.state import init_model
from cu2rec_torch.ops import cuda_draw
from cu2rec_torch.utils.device import resolve_device

# (name, users, items, F, dtype): the benchmark's two configurations and
# ML-20M in bf16.
SHAPES = (("ml20m-f50", 138_493, 26_744, 50, torch.float32),
          ("netflix-f300", 480_189, 17_770, 300, torch.float32),
          ("ml20m-f50-bf16", 138_493, 26_744, 50, torch.bfloat16))
PEAK_BYTES_S = 3.35e12  # H100 SXM data sheet
# The plain version (NumPy, on the host) is timed up to this many words.
PLAIN_WORDS = 20_000_000


def draw_bytes(plan, elem: int) -> int:
    """Least bytes of a draw: the tables written, the windows written and
    read once, and for each transform the sectors its gathers touch (32
    bytes a pair), at most the whole transform."""
    entries = sum(e.n for e in plan)
    pairs = entries // 2
    windows = -(-cuda_draw.plan_words(plan) // cuda_draw.CHUNK) * \
        cuda_draw.MT_N * 4
    return (entries * elem + 2 * windows + min(32 * pairs, 4 << 24)
            + min(32 * pairs, 8 << 24))


def _forget_tables() -> None:
    """The next card draw loads or builds the transforms again, and checks
    them."""
    cuda_draw._host_tables = None
    cuda_draw._device_tables.clear()


def _events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=2 ** 40 + 77)
    p.add_argument("--out", default=None, help="append the records here")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")  # a probe measures the card only
    rec = Records(args.out)
    rec.emit(kind="env", torch=torch.__version__,
             cpu_capability=torch.backends.cpu.get_cpu_capability(),
             cpu_threads=torch.get_num_threads(), cpus=os.cpu_count())

    t0 = time.perf_counter()
    tables = cuda_draw.extract_tables()   # raises where they cannot be
    build_s = time.perf_counter() - t0
    _forget_tables()
    t0 = time.perf_counter()
    cuda_draw.transform_tables()          # writes the cache where it is on
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = cuda_draw.transform_tables()
    load_s = time.perf_counter() - t0
    same = all(torch.equal(a, b) for a, b in zip(tables, cached))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = cuda_draw.device_tables(dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    _forget_tables()                      # again, the kernel built
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = cuda_draw.device_tables(dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rec.emit(kind="tables", build_s=build_s,
             build_or_write_s=write_s, cache_load_s=load_s,
             cache_same=same, first_device_tables_s=first_s,
             warm_device_tables_s=warm_s, cache=str(cuda_draw.cache_path()))
    r, cs = on_card
    lib = cuda_draw._load()

    for name, U, I, F, dtype in SHAPES:
        seed = args.seed + U
        t0 = time.perf_counter()
        want = init_model(U, I, F, 3.5, seed=seed, dtype=dtype, device="cpu")
        cpu_draw_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        moved = [t.to(dev) for t in (want.P, want.Q, want.user_bias,
                                     want.item_bias)]
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        del moved
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = init_model(U, I, F, 3.5, seed=seed, dtype=dtype, device=dev)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        equal = all(torch.equal(getattr(got, k).cpu(), getattr(want, k))
                    for k in ("P", "Q", "user_bias", "item_bias",
                              "global_bias"))
        plan = cuda_draw.draw_plan([("P", U * F), ("Q", I * F),
                                    ("user_bias", U), ("item_bias", I)])
        outs = [got.P.view(-1), got.Q.view(-1), got.user_bias,
                got.item_bias]
        draw_ms = _events_ms(lambda: cuda_draw.normal_draw_cuda(
            seed, plan, outs, r, cs, F), args.reps)
        n_chunks = -(-cuda_draw.plan_words(plan) // cuda_draw.CHUNK)
        windows = torch.empty((n_chunks, cuda_draw.MT_N), dtype=torch.int32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        walk_ms = _events_ms(lambda: lib.normal_draw_windows(
            seed & 0xFFFFFFFF, n_chunks, windows.data_ptr(), stream),
            args.reps)
        gen = torch.Generator(device=dev).manual_seed(seed)
        randn_ms = _events_ms(lambda: [
            torch.randn(e.n, generator=gen, device=dev).div_(F).to(dtype)
            for e in plan], args.reps)
        plain_s = None
        if cuda_draw.plan_words(plan) <= PLAIN_WORDS:
            host = [torch.empty(e.n, dtype=dtype) for e in plan]
            t0 = time.perf_counter()
            cuda_draw.draw_reference(seed, plan, host, r.cpu(), cs.cpu(), F)
            plain_s = time.perf_counter() - t0
            equal = equal and all(torch.equal(h, o.cpu())
                                  for h, o in zip(host, outs))
            del host
        elem = torch.finfo(dtype).bits // 8
        n_bytes = draw_bytes(plan, elem)
        rec.emit(kind="normal_draw", shape=name, dtype=str(dtype),
                 users=U, items=I, F=F, equal=equal,
                 words=cuda_draw.plan_words(plan), chunks=n_chunks,
                 draw_ms=draw_ms, walk_ms=walk_ms,
                 bound_ms=n_bytes / PEAK_BYTES_S * 1e3, bytes=n_bytes,
                 init_card_s=card_s, init_enqueue_s=enqueue_s,
                 cpu_draw_s=cpu_draw_s, upload_s=upload_s,
                 plain_s=plain_s, cuda_randn_ms=randn_ms)
        del got, want, outs, windows
        torch.cuda.empty_cache()
    rec.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
