"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its
own, into ``build/cu2rec_torch/<hash>/lib<name>.so`` at the repository
root, where ``<hash>`` covers the source, the shared ``*.cuh`` headers and
the flags — so an edited source builds anew and an unchanged one loads at
once.  ``build()`` starts one ``nvcc`` per source, all together.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_ROOT = CSRC.parents[1] / "build" / "cu2rec_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("ridge_cholesky", "sgd_step", "eval_error", "row_gather",
           "smem_gather")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _paths(name: str) -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    return src, out_dir / f"lib{name}.so", out_dir / f"{name}.log"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc`` each,
    started together; returns ``{name: library path}``.  Raises with the
    compiler's output if a build fails."""
    procs = {}
    libs = {}
    for name in names:
        src, so, log = _paths(name)
        libs[name] = so
        if so.exists():
            continue
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        out, _ = proc.communicate()
        log.write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build_log(name: str) -> str:
    """The compiler's output (with the ``-Xptxas -v`` register and
    shared-memory report) from the build of ``name``."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (once per process)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _loaded[name] = lib
    return lib
