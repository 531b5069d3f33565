"""Random row gathers ``out[m] = table[idx[m]]`` on the card — kernels K2
and K3, the two gather probes' kernels.

* ``row_gather`` (K2, ``csrc/row_gather.cu``): one bulk copy per row through
  the Tensor Memory Accelerator, 16 in flight per block — the Hopper form of
  the TPU package's ``experiments/gather_roofline.py::_pallas_row_gather``.
* ``smem_gather`` (K3, ``csrc/smem_gather.cu``): the whole table staged in
  each SM's shared memory, rows copied from there — the Hopper form of
  ``experiments/vmem_gather_probe.py::vmem_gather``.

Both take float32 tables whose rows are 16-byte multiples; K2 rows of at
most 2048 bytes, K3 tables of at most ``SMEM_LIMIT_BYTES``.  The checks run
on every device, so the plain versions (``row_gather_reference``,
``smem_gather_reference``: ``table[idx]``) take exactly what the kernels
take.  On CPU tensors each wrapper runs its plain version; on CUDA tensors
it launches its kernel or raises.

Indices must lie in ``[0, I)``.  The wrappers do not check them: that would
cost a reduction and a host sync per call, more than the gather the probes
time.  The kernels read nothing outside the table and give a row of NaN for
an index out of range, where the plain version raises ``IndexError`` (or,
for an index in ``[-I, 0)``, counts from the end as torch indexing does).  ``row_gather.LAUNCHES`` and
``smem_gather.LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

ROW_GATHER_MAX_ROW_BYTES = 2048
# A block's shared memory on an H100 (opt-in maximum): 227 KB.
SMEM_LIMIT_BYTES = 232_448

_libs: dict = {}


class TableTooLarge(ValueError):
    """The table does not fit in a block's shared memory (K3 refuses it
    before anything launches)."""


def _load(name: str):
    lib = _libs.get(name)
    if lib is None:
        from cu2rec_torch.csrc.build import load
        lib = load(name)
        P = ctypes.c_void_p
        if name == "row_gather":
            lib.row_gather_launch.argtypes = [P, P, P, ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_int, P]
            lib.row_gather_launch.restype = ctypes.c_int
        else:
            lib.smem_gather_launch.argtypes = [
                P, P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, P]
            lib.smem_gather_launch.restype = ctypes.c_int
            lib.smem_gather_limit_bytes.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.device != idx.device:
        raise ValueError(f"table on {table.device} but idx on {idx.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"need a float32 table and int32 indices, got "
                        f"{table.dtype} / {idx.dtype}")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need table (I, W) and idx (M,), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    if (table.shape[1] * 4) % 16:
        raise ValueError(f"rows of {table.shape[1] * 4} bytes: a bulk copy "
                         "moves 16-byte multiples")


def _check_cuda(table: torch.Tensor, what: str) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {table.device}")
    if table.data_ptr() % 16:
        raise ValueError(f"{what}: the table must be 16-byte aligned")


def row_gather_reference(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """The plain version of K2 and of K3: ``table[idx]``."""
    return table[idx.to(torch.int64)]


smem_gather_reference = row_gather_reference


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2: ``table[idx]`` by one bulk copy per row.  ``table`` (I, W)
    float32 with 4·W a multiple of 16 and at most 2048; ``idx`` (M,) int32
    rows of the table, in ``[0, I)`` (see the module's note)."""
    _check(table, idx)
    if table.shape[1] * 4 > ROW_GATHER_MAX_ROW_BYTES:
        raise ValueError(f"rows of {table.shape[1] * 4} bytes: K2's ring "
                         f"stages hold {ROW_GATHER_MAX_ROW_BYTES}")
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    _check_cuda(table, "row_gather")
    (I, W), M = table.shape, idx.shape[0]
    out = torch.empty((M, W), dtype=torch.float32, device=table.device)
    if M == 0:
        return out
    lib = _load("row_gather")
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.row_gather_launch(table.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), M, I, W, stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc}")
    row_gather.LAUNCHES += 1
    return out


def smem_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K3: ``table[idx]`` from a table staged in shared memory.  ``table``
    (I, W) float32 of at most ``SMEM_LIMIT_BYTES`` with 4·W a multiple of
    16; ``idx`` (M,) int32 rows of the table, in ``[0, I)`` (see the
    module's note).  A larger table raises
    ``TableTooLarge`` before anything launches."""
    _check(table, idx)
    n_bytes = table.shape[0] * table.shape[1] * 4
    if n_bytes > SMEM_LIMIT_BYTES:
        raise TableTooLarge(f"a table of {n_bytes} bytes does not fit in a "
                         f"block's shared memory ({SMEM_LIMIT_BYTES} bytes)")
    if table.device.type == "cpu":
        return smem_gather_reference(table, idx)
    _check_cuda(table, "smem_gather")
    (I, W), M = table.shape, idx.shape[0]
    out = torch.empty((M, W), dtype=torch.float32, device=table.device)
    if M == 0 or I == 0:
        return out
    lib = _load("smem_gather")
    with torch.cuda.device(table.device):
        if n_bytes > lib.smem_gather_limit_bytes():
            raise TableTooLarge(f"a table of {n_bytes} bytes does not fit in "
                             "this card's shared memory")
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.smem_gather_launch(table.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), M, I, W, stream)
    if rc != 0:
        raise RuntimeError(f"smem_gather launch failed: cudaError {rc}")
    smem_gather.LAUNCHES += 1
    return out


row_gather.LAUNCHES = 0
smem_gather.LAUNCHES = 0
