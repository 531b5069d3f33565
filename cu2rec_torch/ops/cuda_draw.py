"""A model's starting tables drawn on the card, bit for bit the CPU
generator's draw — kernel K5.

``models/state.py::init_model`` draws P, Q, the user and the item bias, in
that order, from ``torch.Generator().manual_seed(seed)`` (the benchmark's
plain reference draws them so too).  On the CPU that is ``torch.randn``,
which for a float32 tensor of n >= 16 entries is:

* n uniforms, each the low 24 bits of one tempered MT19937 word;
* Box–Muller over groups of 16 words: with k1 the 24 bits of word p and k2
  those of word p + 8 (p < 8), entry p = r[k1]·cos[k2] and entry p + 8 =
  r[k1]·sin[k2], each product rounded once, then + 0.0;
* where n % 16 != 0, its last 16 entries drawn again from 16 more words,
  so the tensor takes n + 16 words.

``r``, ``cos`` and ``sin`` are torch's own vectorised functions of a 24-bit
integer, not libm's nor CUDA's.  So ``transform_tables`` tabulates them
from torch's CPU kernel: it sets a CPU generator's state to 608 words of
its choice (``left`` 624, ``next`` 0: no twist before them) and reads back
``torch.randn(608)``.  The pairs (k1, 0) give r[k1]; a k1* whose r is a
power of two then gives, with (k1*, k2), cos[k2] and sin[k2] exactly.  The
tables (192 MB) are cached under ``build/cu2rec_torch/`` by torch's
version, its CPU capability and its ``libtorch_cpu`` file's size and
modification time, and ``device_tables`` trusts them on a device only once
a draw of ``CHECK_SIZES`` there equals ``torch.randn``'s under
``torch.equal``.  Where the tables cannot be built or fail that check it
raises: a card model is drawn by K5 or not at all.

``normal_draw_cuda`` is K5 (``csrc/normal_draw.cu``: one block walks the
MT19937 recurrence 227 words a step and writes the 624-word window that
starts each 8,192-word chunk; a block a chunk rebuilds its words, gathers r
and (cos, sin) and writes the entries); ``draw_reference`` is its plain
version on CPU tensors, which walks the same windows and chunks in numpy.
``LAUNCHES`` counts the kernel's draws.
"""

from __future__ import annotations

import ctypes
import os
from collections import Counter
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from cu2rec_torch.utils.timing import span

KERNEL = "normal_draw"
# Draws K5 made in this process, by table dtype.
LAUNCHES: Counter = Counter()

# The self-check's draw: a fixed seed above 32 bits, several chunks, a
# tail in each table.
CHECK_SEED = 2 ** 32 + 7
CHECK_SIZES = (2 ** 20 + 10, 203, 16, 17)
CHECK_DIVISOR = 3.0

MT_N, MT_M = 624, 397
STEP = MT_N - MT_M              # words a step of the walk
CHUNK = 8192                    # words a draw block starts groups in
SPAN = CHUNK + 16               # words it rebuilds
N24 = 1 << 24
_GROUPS_A_CALL = 38             # 608 words: all before the next twist


class PlanEntry(NamedTuple):
    """One drawn table: its name, entries and first word in the stream."""
    name: str
    n: int
    offset: int


def draw_plan(sizes) -> list[PlanEntry]:
    """The drawn tables in order, ``sizes`` a sequence of (name, entries):
    each starts where the previous one's words end, n of them, 16 more
    where n % 16 != 0 (torch's redrawn tail)."""
    plan, offset = [], 0
    for name, n in sizes:
        plan.append(PlanEntry(name, int(n), offset))
        offset += int(n) + (16 if n % 16 else 0)
    return plan


def plan_words(plan) -> int:
    """Words of the stream the plan takes."""
    last = plan[-1]
    return last.offset + last.n + (16 if last.n % 16 else 0)


def plan_on_card(plan) -> bool:
    """Whether K5 can draw the plan: every table has 16 entries or more
    (a smaller one is drawn by other CPU code, torch's double-precision
    normal)."""
    return bool(plan) and len(plan) <= 4 and all(e.n >= 16 for e in plan)


def draws_on_card(device: torch.device) -> bool:
    """Whether ``init_model`` gives a model for ``device`` to K5: a CUDA
    device (a CPU model is drawn where it lives)."""
    return device.type == "cuda"


# -- MT19937 ------------------------------------------------------------------

def mt_state(seed: int) -> np.ndarray:
    """x[0..623] of the stream torch's CPU generator seeded with ``seed``
    walks (``at::mt19937::init_with_uint32(seed & 0xffffffff)``)."""
    x = np.empty(MT_N, np.uint32)
    v = int(seed) & 0xFFFFFFFF
    x[0] = v
    for j in range(1, MT_N):
        v = (1812433253 * (v ^ (v >> 30)) + j) & 0xFFFFFFFF
        x[j] = v
    return x


def _twist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y = (a & np.uint32(0x80000000)) | (b & np.uint32(0x7FFFFFFF))
    return (y >> np.uint32(1)) ^ np.where(b & np.uint32(1),
                                          np.uint32(0x9908B0DF),
                                          np.uint32(0))


def mt_walk(window: np.ndarray, n: int) -> np.ndarray:
    """The 624 words of ``window`` and the n that follow them,
    x[k + 624] = x[k + 397] ^ twist(x[k], x[k + 1]), 227 at a time as K5
    walks them."""
    x = np.empty(MT_N + n, np.uint32)
    x[:MT_N] = window
    for i in range(0, n, STEP):
        m = min(STEP, n - i)
        x[MT_N + i:MT_N + i + m] = x[MT_M + i:MT_M + i + m] ^ _twist(
            x[i:i + m], x[i + 1:i + m + 1])
    return x


def temper(y: np.ndarray) -> np.ndarray:
    y = y ^ (y >> np.uint32(11))
    y = y ^ ((y << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    return y ^ (y >> np.uint32(18))


def untemper(y: np.ndarray) -> np.ndarray:
    """The state word whose tempered output is ``y``."""
    y = np.asarray(y, np.uint32)
    y = y ^ (y >> np.uint32(18))
    y = y ^ ((y << np.uint32(15)) & np.uint32(0xEFC60000))
    t = y
    for _ in range(4):
        t = y ^ ((t << np.uint32(7)) & np.uint32(0x9D2C5680))
    y = t
    for _ in range(2):
        t = y ^ (t >> np.uint32(11))
    return t


def mt_windows(seed: int, n_windows: int) -> np.ndarray:
    """(n_windows, 624) uint32: window c is x[c·CHUNK .. c·CHUNK + 623],
    as K5's walk writes them (output word m is temper(x[624 + m]))."""
    x = mt_walk(mt_state(seed), (n_windows - 1) * CHUNK)
    return np.stack([x[c * CHUNK:c * CHUNK + MT_N]
                     for c in range(n_windows)])


# -- the transforms -----------------------------------------------------------

# torch's CPU generator state (``CPUGeneratorImplState``): the initial seed
# (uint64), left (int32), seeded (int32), next (uint64), then 624 uint64
# state words, ...
_LEFT, _NEXT, _WORDS = 8, 16, 24


def _state_layout_ok(state: torch.Tensor) -> bool:
    """Whether ``get_state`` lays the state out as this module writes it:
    checked on a seeded generator (left 1, next 0, x[0] the seed)."""
    s = torch.Generator().manual_seed(0x12345).get_state().numpy()
    return (state.numel() == s.size and s.size >= _WORDS + 8 * MT_N and
            s[_LEFT:_LEFT + 4].view(np.int32)[0] == 1 and
            s[_NEXT:_NEXT + 8].view(np.uint64)[0] == 0 and
            s[_WORDS:_WORDS + 8].view(np.uint64)[0] == 0x12345)


def _box_muller(first: np.ndarray, second: np.ndarray):
    """torch's CPU outputs (r[k1]·cos[k2], r[k1]·sin[k2]) for each pair
    (k1, k2) = (first[i], second[i]), 304 pairs a ``torch.randn(608)``."""
    gen = torch.Generator()
    state = gen.get_state()
    if not _state_layout_ok(state):
        raise RuntimeError(
            f"K5's transforms cannot be built: torch {torch.__version__}'s "
            "CPU generator state is not laid out as cuda_draw writes it "
            f"(left at byte {_LEFT}, next at {_NEXT}, the words at "
            f"{_WORDS})")
    sn = state.numpy()
    sn[_LEFT:_LEFT + 4] = np.array([MT_N], np.int32).view(np.uint8)
    sn[_NEXT:_NEXT + 8] = np.zeros(1, np.uint64).view(np.uint8)
    words = sn[_WORDS:_WORDS + 8 * MT_N].view(np.uint64)
    per = 8 * _GROUPS_A_CALL                # pairs a call
    m = first.size
    cos_side = np.empty(m, np.float32)
    sin_side = np.empty(m, np.float32)
    block = 4096                            # calls a block
    out = torch.empty(block, _GROUPS_A_CALL, 2, 8)
    for lo in range(0, m, block * per):
        hi = min(m, lo + block * per)
        calls = -(-(hi - lo) // per)
        w = np.empty((calls, _GROUPS_A_CALL, 2, 8), np.uint32)
        for side, src in ((0, first), (1, second)):
            k = np.zeros(calls * per, np.uint32)
            k[:hi - lo] = src[lo:hi]
            w[:, :, side] = k.reshape(calls, _GROUPS_A_CALL, 8)
        st = untemper(w.reshape(calls, 2 * per)).astype(np.uint64)
        for c in range(calls):
            words[:2 * per] = st[c]
            gen.set_state(state)
            torch.randn(2 * per, generator=gen, out=out[c].view(-1))
        got = out[:calls].numpy()
        cos_side[lo:hi] = got[:, :, 0].reshape(-1)[:hi - lo]
        sin_side[lo:hi] = got[:, :, 1].reshape(-1)[:hi - lo]
    return cos_side, sin_side


def extract_tables():
    """(r, cs): r (2^24,) and cs (2^24, 2) float32 CPU tensors, cos and sin
    interleaved, from torch's CPU ``randn``.  Raises where the generator's
    state is laid out otherwise or no radius is a power of two."""
    k = np.arange(N24, dtype=np.uint32)
    r, _ = _box_muller(k, np.zeros(N24, np.uint32))
    mant, _exp = np.frexp(r)
    pow2 = np.nonzero((mant == 0.5) & (r > 0))[0]
    if pow2.size == 0:
        raise RuntimeError(
            f"K5's transforms cannot be built: no radius of torch "
            f"{torch.__version__}'s CPU randn is a power of two, so cos and "
            "sin cannot be read exactly")
    one = np.nonzero(r == 1.0)[0]
    k1 = int(one[0] if one.size else pow2[np.argmin(np.abs(np.log2(
        r[pow2])))])
    c, s = _box_muller(np.full(N24, k1, np.uint32), k)
    scale = np.float32(r[k1])
    cs = np.stack([c / scale, s / scale], axis=1)
    return torch.from_numpy(r), torch.from_numpy(cs)


def _libtorch_stamp() -> str:
    """The size and modification time of the ``libtorch_cpu`` library this
    torch loads, whose vectorised log, cos and sin the tables hold: two
    builds under one version string get two caches."""
    lib = Path(torch.__file__).parent / "lib"
    for f in sorted(lib.glob("libtorch_cpu.*")):
        st = f.stat()
        return f"{st.st_size}-{st.st_mtime_ns}"
    return "nolib"


def cache_path():
    """Where the tables of this torch build and this CPU are kept."""
    from cu2rec_torch.csrc.build import BUILD_ROOT
    key = (f"{torch.__version__}-{torch.backends.cpu.get_cpu_capability()}-"
           f"{_libtorch_stamp()}")
    key = "".join(ch if ch.isalnum() or ch in "._-" else "_" for ch in key)
    return BUILD_ROOT / "normal_tables" / f"{key}.npy"


def transform_tables():
    """``extract_tables``, from the cache where it holds them, else built
    and written there (a temporary file renamed into place)."""
    path = cache_path()
    if path.exists():
        flat = torch.from_numpy(np.load(path))
        if flat.numel() == 3 * N24:
            return flat[:N24], flat[N24:].view(N24, 2)
    tables = extract_tables()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        np.save(f, torch.cat([tables[0], tables[1].reshape(-1)]).numpy())
    os.replace(tmp, path)
    return tables


# -- the draw -----------------------------------------------------------------

def _words(seed: int, n: int) -> np.ndarray:
    """The stream's first n output words' 24 bits, chunk by chunk from the
    windows, as K5's draw blocks rebuild them: (n_chunks, SPAN)."""
    n_chunks = -(-n // CHUNK)
    wins = mt_windows(seed, n_chunks)
    return np.stack([temper(mt_walk(w, SPAN)[MT_N:]) & np.uint32(N24 - 1)
                     for w in wins])


def draw_reference(seed: int, plan, outs, r: torch.Tensor,
                   cs: torch.Tensor, divisor: float) -> None:
    """The plain version of K5 on CPU tensors: fills ``outs`` (one a plan
    entry, float32 or bf16) as the kernel does, group by group from each
    chunk's rebuilt words, each entry written by one group."""
    words = _words(seed, plan_words(plan))
    div = np.float32(divisor)
    j = np.arange(16)
    for e, out in zip(plan, outs):
        starts = e.offset + 16 * np.arange(e.n // 16)
        if e.n % 16:                        # the tail group, last
            starts = np.append(starts, e.offset + e.n)
        w = words[(starts // CHUNK)[:, None], (starts % CHUNK)[:, None] + j]
        rr = r.numpy()[w[:, :8]]
        c, s = cs.numpy()[w[:, 8:]].transpose(2, 0, 1)
        # + 0 after the product: torch's fma(x, 1, 0), which makes -0 +0
        groups = np.concatenate([rr * c + np.float32(0),
                                 rr * s + np.float32(0)], axis=1) / div
        vals = np.empty(e.n, np.float32)
        vals[:16 * (e.n // 16)] = groups[:e.n // 16].reshape(-1)
        if e.n % 16:                        # the tail's [n - 16, n)
            vals[e.n - 16:] = groups[-1]
        out.copy_(torch.from_numpy(vals).view(out.shape))


class _DrawTable(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("offset", ctypes.c_longlong)]


class _DrawPlan(ctypes.Structure):
    _fields_ = [("t", _DrawTable * 4), ("count", ctypes.c_int)]


_lib = None


def _load():
    global _lib
    if _lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(KERNEL)
        P = ctypes.c_void_p
        lib.normal_draw_chunk.restype = ctypes.c_int
        lib.normal_draw_windows.argtypes = [ctypes.c_uint32,
                                            ctypes.c_longlong, P, P]
        lib.normal_draw_windows.restype = ctypes.c_int
        lib.normal_draw_launch.argtypes = [
            P, ctypes.c_longlong, P, P, _DrawPlan, ctypes.c_float,
            ctypes.c_int, P]
        lib.normal_draw_launch.restype = ctypes.c_int
        if lib.normal_draw_chunk() != CHUNK:
            raise RuntimeError("normal_draw.cu's chunk differs from "
                               "cuda_draw.CHUNK")
        _lib = lib
    return _lib


_ELEM = {torch.float32: 0, torch.bfloat16: 1}


def normal_draw_cuda(seed: int, plan, outs, r: torch.Tensor,
                     cs: torch.Tensor, divisor: float) -> None:
    """K5: fills ``outs`` (contiguous CUDA tensors of one dtype, float32 or
    bf16, one a plan entry of n >= 16) on the current stream, not yet
    synchronized; ``r``, ``cs`` the transforms on the same device."""
    device = outs[0].device
    if device.type != "cuda":
        raise ValueError(f"normal_draw_cuda takes CUDA tensors, got {device}")
    if not plan_on_card(plan) or len(outs) != len(plan):
        raise ValueError(f"bad plan for K5: {plan}")
    dtype = outs[0].dtype
    if dtype not in _ELEM:
        raise TypeError(f"tables must be float32 or bfloat16, got {dtype}")
    for e, t in zip(plan, outs):
        if t.device != device or t.dtype != dtype or \
                not t.is_contiguous() or t.numel() != e.n:
            raise ValueError(f"table {e.name}: {tuple(t.shape)} {t.dtype} "
                             f"on {t.device} for {e.n} entries")
    if r.device != device or cs.device != device or \
            r.numel() != N24 or cs.numel() != 2 * N24:
        raise ValueError("the transforms must be on the tables' device")
    lib = _load()
    n_chunks = -(-plan_words(plan) // CHUNK)
    windows = torch.empty((n_chunks, MT_N), dtype=torch.int32,
                          device=device)
    c_plan = _DrawPlan()
    for i, (e, t) in enumerate(zip(plan, outs)):
        c_plan.t[i] = _DrawTable(t.data_ptr(), e.n, e.offset)
    c_plan.count = len(plan)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.normal_draw_windows(int(seed) & 0xFFFFFFFF, n_chunks,
                                     windows.data_ptr(), stream)
        if rc == 0:
            rc = lib.normal_draw_launch(
                windows.data_ptr(), n_chunks, r.data_ptr(), cs.data_ptr(),
                c_plan, float(divisor), _ELEM[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"normal_draw launch failed: cudaError {rc}")
    LAUNCHES[dtype] += 1


# -- the tables a device may use ----------------------------------------------

_host_tables = None             # (r, cs) on the CPU once built or loaded
_device_tables: dict = {}       # device -> (r, cs) on it, checked


def _device_key(device: torch.device) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def self_check(device, r, cs) -> None:
    """Raise unless a draw of ``CHECK_SIZES`` with K5 on ``device`` and
    these transforms equals ``torch.randn``'s on the CPU under
    ``torch.equal``; the message names the first entry that differs."""
    plan = draw_plan((str(i), n) for i, n in enumerate(CHECK_SIZES))
    outs = [torch.empty(e.n, device=device) for e in plan]
    normal_draw_cuda(CHECK_SEED, plan, outs, r, cs, CHECK_DIVISOR)
    gen = torch.Generator().manual_seed(CHECK_SEED)
    for e, out in zip(plan, outs):
        got = out.cpu()
        want = torch.randn(e.n, generator=gen) / CHECK_DIVISOR
        if not torch.equal(got, want):
            j = int(torch.nonzero(got != want)[0])
            raise RuntimeError(
                f"K5's self-check failed on {device}: table {e.name} of "
                f"{e.n} entries (seed {CHECK_SEED}) differs from torch's "
                f"CPU randn first at entry {j}: {got[j].item()!r} against "
                f"{want[j].item()!r}; the transforms (cache "
                f"{cache_path()}) are not this torch's")


def device_tables(device):
    """(r, cs) on ``device`` for its draws, built or loaded and checked at
    the first call of the process for that device (span
    ``model.init.draw.tables``).  Raises where they cannot be built or fail
    the check."""
    key = _device_key(torch.device(device))
    if key in _device_tables:
        return _device_tables[key]
    global _host_tables
    with span("model.init.draw.tables"):
        if _host_tables is None:
            _host_tables = transform_tables()
        r, cs = (t.to(key) for t in _host_tables)
        self_check(key, r, cs)
        _device_tables[key] = (r, cs)
    return r, cs
