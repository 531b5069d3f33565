"""Build the port's CUDA kernels with ``nvcc`` and its host library with
``g++``, and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles, on its
own, into ``build/cu2rec_torch/<hash>/lib<name>.so`` at the repository
root, where ``<hash>`` covers the source, the shared ``*.cuh`` headers and
the flags — so an edited source builds anew and an unchanged one loads at
once.  ``build()`` starts one ``nvcc`` per source, all together.  The host
library ``csrc/ingest.cpp`` (CSV ingest and export, no device code) builds
the same way with ``g++`` (``build_host``); it is not in ``KERNELS``.  A
build writes a temporary file and renames it into place, so processes that
build the same library at once each load a whole one.  Nothing here runs at
import time.
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
KERNELS = ("ridge_cholesky", "sgd_step", "sgd_sharded", "eval_error",
           "row_gather", "smem_gather", "foldin", "gather_gram",
           "normal_draw", "bpr_step")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def gxx() -> str | None:
    """The host C++ compiler, ``g++`` on the path, or None where there is
    none."""
    return shutil.which("g++")


def _paths(name: str, ext: str = ".cu") -> tuple[Path, Path, Path]:
    src = CSRC / f"{name}{ext}"
    if ext == ".cu":
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC.glob("*.cuh")))
        flags = NVCC_FLAGS
    else:
        headers, flags = b"", GXX_FLAGS
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
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


def build_host(name: str = "ingest") -> Path:
    """Compile ``csrc/<name>.cpp`` with the host compiler if it is not
    built yet; returns the library's path.  Raises with the compiler's
    output if the build fails, and where there is no compiler."""
    src, so, _log = _paths(name, ".cpp")
    if so.exists():
        return so
    compiler = gxx()
    if compiler is None:
        raise RuntimeError(f"no host C++ compiler found to build {src.name}")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    proc = subprocess.run(
        [compiler, *GXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{compiler} failed for {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, so)
    return so


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
