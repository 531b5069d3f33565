"""Device selection: the port runs on the GPU unless the caller asks for the
CPU.  Nothing falls back to the CPU silently — a missing card is an error."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the CUDA device (raises ``RuntimeError`` when
    there is none); ``"cpu"`` → the CPU.  Accepts a ``torch.device`` or any
    string ``torch.device`` parses (``"cuda:0"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")


def free_memory_bytes(device=None):
    """(free_bytes, total_bytes) of a CUDA device, or (None, None) for the
    CPU, which reports no device memory."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None, None
    return torch.cuda.mem_get_info(dev)


def print_free_memory(device=None) -> None:
    """The startup free-memory line (``getFreeBytes``, reference
    util.cu:184-195, printed by mf.cu:33-37)."""
    free, _total = free_memory_bytes(device)
    if free is None:
        print("Free memory: n/a (backend exposes no memory stats)\n")
    else:
        print(f"Free memory: {free}\n")
