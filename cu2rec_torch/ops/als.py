"""ALS building blocks — for now only the ridge-solve dispatch.

``_ridge_finish`` keeps the TPU package's solver names ("auto", "blocked",
"pallas", "xla") so callers port unchanged, but on this card every name is
the same solve: kernel K1 on a CUDA tensor, its plain version on a CPU
tensor (``ops/cuda_linalg.py``).  The TPU package needed several solvers
because its Pallas kernel padded small batches to a lane tile and had a
VMEM ceiling; K1 has neither.  The ALS sweeps come with their own slice.
"""

from __future__ import annotations

from cu2rec_torch.ops.cuda_linalg import ridge_solve_batched_cuda

SOLVERS = ("auto", "blocked", "pallas", "xla")


def _ridge_finish(G, rhs, solver: str):
    """θ = G⁻¹ rhs for ``G`` (B, N, N) SPD and ``rhs`` (B, N)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r} (one of {SOLVERS})")
    return ridge_solve_batched_cuda(G.contiguous(), rhs.contiguous())
