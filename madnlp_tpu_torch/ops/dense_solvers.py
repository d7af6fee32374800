"""Uniform functional interface over the dense factorization backends —
port of ``madnlp_tpu/ops/dense_solvers.py`` (``DenseFactor``,
``factorize``, ``solve``, ``inertia``, ``has_inertia``).

Backends (reference: src/LinearSolvers/lapack_common.jl:47-109):

* ``LDL``       — blocked unpivoted LDLᵀ (:func:`.dense_kernels.dense_ldlt`:
                  the kernel K7 on the card, its plain version on the CPU);
                  inertia from pivots.
* ``CHOLESKY``  — ``torch.linalg.cholesky_ex``; inertia = success ? (n,0,0)
                  : (0,n,0), from its ``info`` (lapack_common.jl:100-102);
                  a failed factor is NaN, as XLA's is.
* ``LU``        — ``torch.linalg.lu_factor``; no inertia.
* ``QR``        — ``torch.linalg.qr``; no inertia.
* ``EVD``       — ``torch.linalg.eigh``; exact inertia.

``solve_mode="inverse"`` inverts the triangular factor once at
factorization time so that every backsolve is two mat-vecs; the solver's
default is ``"trisolve"`` on every device.  ``BLOCK_CHOLESKY`` and
``HYKKT`` come in a later slice of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.options import LinearSolver
from . import dense_kernels as _dense_kernels
from . import ldlt as _ldlt


class DenseFactor(NamedTuple):
    """Backend-specific factor payload: ``kind`` names the backend (and the
    solve mode), ``a``/``b`` hold its tensors, ``n`` the system size."""

    kind: str
    a: torch.Tensor
    b: torch.Tensor
    n: int


def _later(what: str):
    return NotImplementedError(f"{what} comes in a later slice of the port")


def _tri_inverse(L: torch.Tensor, unit: bool = False) -> torch.Tensor:
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False,
                                         unitriangular=unit)


def factorize(K: torch.Tensor, solver: LinearSolver, block: int = 64,
              solve_mode: str = "trisolve") -> DenseFactor:
    n = K.shape[0]
    inv = solve_mode == "inverse"
    if solver in (LinearSolver.BLOCK_CHOLESKY, LinearSolver.HYKKT):
        raise _later(f"linear_solver={solver}")
    if solver == LinearSolver.LDL:
        f = _dense_kernels.dense_ldlt(K, block=block)
        if inv:
            return DenseFactor("ldl_inv", _tri_inverse(f.L, unit=True), f.d, n)
        return DenseFactor("ldl", f.L, f.d, n)
    if solver == LinearSolver.CHOLESKY:
        L, info = torch.linalg.cholesky_ex(K)
        # a failed factorization is all NaN, as XLA's cholesky returns it:
        # its backsolve then ends the refinement at once, as in the JAX
        # package (a partial factor would run the refinement to its cap)
        L = torch.where(info == 0, L, torch.nan)
        if inv:
            return DenseFactor("chol_inv", _tri_inverse(L), info, n)
        return DenseFactor("cholesky", L, info, n)
    if solver == LinearSolver.LU:
        lu, piv = torch.linalg.lu_factor(K)
        return DenseFactor("lu", lu, piv, n)
    if solver == LinearSolver.EVD:
        w, V = torch.linalg.eigh(K)
        return DenseFactor("evd", V, w, n)
    if solver == LinearSolver.QR:
        q, r = torch.linalg.qr(K)
        return DenseFactor("qr", q, r, n)
    raise ValueError(f"unsupported dense solver {solver}")


def zero_factor(solver: LinearSolver, n: int, dtype, block: int = 64,
                solve_mode: str = "trisolve", device=None) -> DenseFactor:
    """The all-zero factor of :func:`factorize`'s kind and shapes (the JAX
    package's ``zero_factor``): the persisted context of a solve that has
    factored nothing yet.  Its solves are not finite, as there."""
    inv = solve_mode == "inverse"

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if solver == LinearSolver.LDL:
        np_ = max(1, -(-n // block)) * block
        return DenseFactor("ldl_inv" if inv else "ldl", z(np_, np_), z(np_), n)
    if solver == LinearSolver.CHOLESKY:
        if inv:
            return DenseFactor("chol_inv", z(n, n), z(dt=torch.int32), n)
        return DenseFactor("cholesky", z(n, n), z(dt=torch.int32), n)
    if solver == LinearSolver.LU:
        return DenseFactor("lu", z(n, n),
                           torch.arange(1, n + 1, dtype=torch.int32,
                                        device=device), n)
    if solver == LinearSolver.EVD:
        return DenseFactor("evd", z(n, n), z(n), n)
    if solver == LinearSolver.QR:
        return DenseFactor("qr", z(n, n), z(n, n), n)
    raise _later(f"linear_solver={solver}")


def solve(factor: DenseFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Backsolve; ``rhs`` is (n,) or (n, k)."""
    kind = factor.kind
    squeeze = rhs.ndim == 1
    b = rhs[:, None] if squeeze else rhs
    if kind == "ldl":
        x = _ldlt.ldlt_solve(_ldlt.LDLFactor(factor.a, factor.b, factor.n), b)
    elif kind == "ldl_inv":
        Linv, d, n = factor.a, factor.b, factor.n
        np_ = Linv.shape[0]
        if np_ != n:
            b = torch.cat([b, b.new_zeros((np_ - n, b.shape[1]))])
        z = Linv @ b
        x = (Linv.T @ (z / _ldlt.pivot_div(d)[:, None]))[:n]
    elif kind == "cholesky":
        L = factor.a
        z = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.T, z, upper=True)
    elif kind == "chol_inv":
        Linv = factor.a
        x = Linv.T @ (Linv @ b)
    elif kind == "lu":
        x = torch.linalg.lu_solve(factor.a, factor.b, b)
    elif kind == "evd":
        V, w = factor.a, factor.b
        x = V @ ((V.T @ b) / _ldlt.pivot_div(w)[:, None])
    elif kind == "qr":
        q, r = factor.a, factor.b
        x = torch.linalg.solve_triangular(r, q.T @ b, upper=True)
    else:
        raise ValueError(kind)
    return x[:, 0] if squeeze else x


def has_inertia(solver: LinearSolver) -> bool:
    return solver in (
        LinearSolver.LDL,
        LinearSolver.CHOLESKY,
        LinearSolver.BLOCK_CHOLESKY,
        LinearSolver.HYKKT,
        LinearSolver.EVD,
        LinearSolver.BANDED,
        LinearSolver.BLOCK_ARROW,
        LinearSolver.MULTIFRONTAL,
    )


def inertia(factor: DenseFactor) -> Tuple[int, int, int]:
    """(num_pos, num_zero, num_neg) as host ints."""
    kind, n = factor.kind, factor.n
    if kind in ("ldl", "ldl_inv"):
        return _ldlt.ldlt_inertia(_ldlt.LDLFactor(factor.a, factor.b, n))
    if kind in ("cholesky", "chol_inv"):
        # Cholesky success as inertia: info == 0 means K is positive definite
        ok = int(factor.b) == 0
        return (n, 0, 0) if ok else (0, n, 0)
    if kind == "evd":
        # absolute tiny threshold, consistent with the LDLᵀ backend
        w = factor.b
        tol = _ldlt.ZERO_PIVOT_TOL
        pos, neg = torch.stack([(w > tol).sum(), (w < -tol).sum()]).tolist()
        return pos, n - pos - neg, neg
    raise ValueError(f"solver kind {kind} does not expose inertia")
