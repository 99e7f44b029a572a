"""Batched SPD solves: the per-segment normal equations of ALS,
``[S, K, K] @ x = [S, K]`` (port of the reference's ``ops/linalg.py``).

K is small (the factor rank or the subspace block, 10-128) and S is huge
(one system per user or item). Three implementations, as in the
reference:

- :func:`cholesky_solve_xla` — ``torch.linalg.cholesky_ex`` +
  ``torch.cholesky_solve``, the library path (the counterpart of the
  reference's ``jax.scipy`` ``cho_factor``/``cho_solve``).
- :func:`cholesky_solve_vec` — a K-step right-looking Cholesky written
  over the whole batch, then forward and back substitution. This is the
  plain version of the hand-written kernel: the CPU runs it, and the
  tests and ``chip_smoke.py`` hold the kernel against it.
- :func:`spd_solve` — the hand-written Hopper kernel
  (``csrc/spd_solve.cu``, one warp per system, the counterpart of the
  Pallas ``_spd_solve_kernel``) on CUDA tensors; the plain version on
  CPU tensors.

:func:`batched_spd_solve` adds the jitter and picks one of them by
``PIO_TPU_SOLVE`` with the reference's values and rule.
"""

from __future__ import annotations

import os

import torch

from predictionio_tpu_torch.ops import kernels

#: ranks up to this take the hand-written kernel under ``auto`` (the
#: reference's ``_PALLAS_MAX_K``); the kernel refuses larger K
_PALLAS_MAX_K = 64

SOLVE_METHODS = ("auto", "xla", "vec", "pallas")


def cholesky_solve_xla(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A[s] x = b[s]`` through PyTorch's batched Cholesky
    (the library path)."""
    L, _info = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def _vec_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Right-looking Cholesky, one batch-wide update per column. Returns
    L in the lower triangle (the strict upper triangle keeps A's values
    and is never read). The diagonal is floored at 1e-30 before rsqrt,
    as in the reference."""
    L = A.clone()
    k = A.shape[-1]
    for j in range(k):
        d = torch.rsqrt(torch.clamp_min(L[:, j, j], 1e-30))       # [S]
        col = L[:, j:, j] * d[:, None]                           # [S, K-j]
        L[:, j:, j] = col
        tail = col[:, 1:]
        L[:, j + 1:, j + 1:] -= tail[:, :, None] * tail[:, None, :]
    return L


def _vec_solve_tri(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (L L^T)^{-1} b by forward then back substitution, reading
    only the lower triangle of L."""
    k = b.shape[-1]
    y = torch.zeros_like(b)
    for j in range(k):
        acc = (L[:, j, :j] * y[:, :j]).sum(dim=1)
        y[:, j] = (b[:, j] - acc) / L[:, j, j]
    x = torch.zeros_like(b)
    for j in range(k - 1, -1, -1):
        acc = (L[:, j + 1:, j] * x[:, j + 1:]).sum(dim=1)
        x[:, j] = (y[:, j] - acc) / L[:, j, j]
    return x


def cholesky_solve_vec(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve SPD ``A[s] x = b[s]``, vectorized over the batch: the plain
    version of the hand-written kernel (the counterpart of the
    reference's ``cholesky_solve_vec``)."""
    return _vec_solve_tri(_vec_cholesky(A), b)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The B1 solve: CUDA tensors launch ``csrc/spd_solve.cu`` (or
    raise); CPU tensors take :func:`cholesky_solve_vec` (the counterpart
    of the reference's ``interpret=True``)."""
    if A.is_cuda:
        return kernels.spd_solve_cuda(A.contiguous(), b.contiguous())
    return cholesky_solve_vec(A, b)


def solve_method() -> str:
    """``PIO_TPU_SOLVE`` as the reference reads it; other values raise."""
    method = os.environ.get("PIO_TPU_SOLVE", "auto").strip().lower()
    if method not in SOLVE_METHODS:
        raise ValueError(
            f"PIO_TPU_SOLVE={method!r}: expected auto|xla|vec|pallas")
    return method


def batched_spd_solve(A: torch.Tensor, b: torch.Tensor,
                      jitter: float = 1e-6) -> torch.Tensor:
    """Solve ``A[s] x[s] = b[s]`` for SPD A, ``[S, K, K] x [S, K] ->
    [S, K]``.

    A small diagonal jitter keeps empty segments (A ~ 0) from producing
    NaNs; their rhs is 0, so their solution stays exactly 0. Method:
    ``PIO_TPU_SOLVE`` (``pallas`` | ``vec`` | ``xla``) overrides; the
    default ``auto`` takes the hand-written kernel on a CUDA tensor for
    K <= 64 and the vectorized path otherwise, the reference's rule with
    the card in the TPU's place.
    """
    k = A.shape[-1]
    method = solve_method()
    A = A + jitter * torch.eye(k, dtype=A.dtype, device=A.device)
    if method == "xla":
        return cholesky_solve_xla(A, b)
    if method == "vec":
        return cholesky_solve_vec(A, b)
    if method == "pallas" or (k <= _PALLAS_MAX_K and A.is_cuda):
        return spd_solve(A, b)
    return cholesky_solve_vec(A, b)
