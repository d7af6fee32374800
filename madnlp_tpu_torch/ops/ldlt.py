"""Blocked dense LDLᵀ factorization with inertia — port of
``madnlp_tpu/ops/ldlt.py`` (``LDLFactor``, ``ldlt_factorize``,
``ldlt_solve``, ``ldlt_inertia``).

Right-looking, blocked, unpivoted: the IPM's inertia-correction ladder
re-regularizes and refactors whenever the factor is inaccurate or the
inertia wrong, so no pivoting is needed.  A pivot with
``|d| <= ZERO_PIVOT_TOL`` divides as inf (its column of L vanishes) and
counts as zero in the inertia; non-finite pivots count as zero too.

``ldlt_factorize`` is the counterpart of the JAX package's XLA code, not of
a TPU kernel: plain torch on every device, with the trailing update as one
``torch.matmul`` per block column.  The JAX package updates the trailing
matrix with a full-width GEMM whose rows and columns above the current
block are masked to zero; those entries are never read again (every later
step masks them out before use), so the port updates only the trailing
block ``[below, below]`` and the result is the same on every entry that is
read.  The port's dense path factors with the whole-matrix kernel of the
same recursion instead (K7, ``madnlp_tpu/ops/pallas_ldlt.py``, ported as
:func:`.dense_kernels.dense_ldlt`); ``ldlt_factorize`` stays as the
reference it is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .banded import ZERO_PIVOT_TOL, host_view, pivot_div


class LDLFactor(NamedTuple):
    L: torch.Tensor    # (Np, Np) unit lower triangular (padded)
    d: torch.Tensor    # (Np,) pivots (padded entries = 1)
    n: int             # logical dimension


def pad_identity(A: torch.Tensor, block: int) -> torch.Tensor:
    """``A (n, n)`` padded to ``Np = ⌈n/block⌉·block`` with an identity tail
    (``+pad`` positive pivots, removed again by :func:`ldlt_inertia`)."""
    n = A.shape[0]
    np_ = max(1, -(-n // block)) * block
    if np_ == n:
        return A
    out = torch.zeros((np_, np_), dtype=A.dtype, device=A.device)
    out[:n, :n] = A
    idx = torch.arange(n, np_, device=A.device)
    out[idx, idx] = 1.0
    return out


def ldlt_unblocked(A: torch.Tensor) -> torch.Tensor:
    """LDLᵀ of a small (b, b) full symmetric block by rank-1 steps, on a
    copy; returns the strict-lower L with D on the diagonal, in one
    matrix (the upper triangle is don't-care)."""
    A = A.clone()
    H = host_view(A)
    for j in range(H.shape[0]):
        dj = H[j, j]
        lj = H[j + 1:, j] / pivot_div(dj)
        # rows and columns ≤ j of the JAX package's full-block update
        # subtract dj·0 and are never read again
        H[j + 1:, j + 1:] -= dj * (lj[:, None] * lj[None, :])
        H[j + 1:, j] = lj
    return A


def ldlt_factorize(A: torch.Tensor, block: int = 64) -> LDLFactor:
    """Factorize the symmetric ``A = L D Lᵀ`` (full matrix input, no
    pivoting), padded to a multiple of ``block``."""
    n = A.shape[0]
    W = pad_identity(A, block).clone()
    np_ = W.shape[0]
    eye_b = torch.eye(block, dtype=A.dtype, device=A.device)
    L = torch.zeros((np_, np_), dtype=A.dtype, device=A.device)
    d = torch.zeros((np_,), dtype=A.dtype, device=A.device)
    for kb in range(0, np_, block):
        s = kb + block
        LD = ldlt_unblocked(W[kb:s, kb:s])
        Lkk = torch.tril(LD, -1) + eye_b
        dk = torch.diagonal(LD).clone()
        invLkk = torch.linalg.solve_triangular(Lkk, eye_b, upper=False,
                                               unitriangular=True)
        X = W[s:, kb:s] @ invLkk.T
        Lcol = X / pivot_div(dk)
        W[s:, s:] -= Lcol @ X.T
        L[kb:s, kb:s] = Lkk
        L[s:, kb:s] = Lcol
        d[kb:s] = dk
    return LDLFactor(L=L, d=d, n=n)


def ldlt_solve(factor: LDLFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = b`` given ``A = L D Lᵀ``; ``b``: (n,) or (n, k)."""
    L, d, n = factor
    np_ = L.shape[0]
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    if np_ != n:
        b = torch.cat([b, b.new_zeros((np_ - n, b.shape[1]))])
    z = torch.linalg.solve_triangular(L, b, upper=False, unitriangular=True)
    w = z / pivot_div(d)[:, None]
    x = torch.linalg.solve_triangular(L.T, w, upper=True,
                                      unitriangular=True)[:n]
    return x[:, 0] if squeeze else x


def ldlt_inertia(factor: LDLFactor) -> Tuple[int, int, int]:
    """Inertia (num_pos, num_zero, num_neg) from the pivot signs, as host
    ints (one device read).  Non-finite pivots count as zeros, so the
    caller's inertia check fails and regularizes."""
    L, d, n = factor
    finite = torch.isfinite(d)
    counts = torch.stack([((d > ZERO_PIVOT_TOL) & finite).sum(),
                          ((d < -ZERO_PIVOT_TOL) & finite).sum()])
    pos, neg = counts.tolist()
    pos -= L.shape[0] - n
    return pos, n - pos - neg, neg
