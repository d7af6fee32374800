"""Uniform functional interface over the dense factorization backends —
port of ``madnlp_tpu/ops/dense_solvers.py`` (``DenseFactor``,
``zero_factor``, ``factorize``, ``solve``, ``inertia``, ``has_inertia``).

Backends (reference: src/LinearSolvers/lapack_common.jl:47-109):

* ``LDL``       — blocked unpivoted LDLᵀ (:func:`.dense_kernels.dense_ldlt`:
                  the kernel K7 on the card, its plain version on the CPU);
                  inertia from pivots.
* ``CHOLESKY``  — ``torch.linalg.cholesky_ex``; inertia = success ? (n,0,0)
                  : (0,n,0), from its ``info`` (lapack_common.jl:100-102);
                  a failed factor is NaN, as XLA's is.
* ``BLOCK_CHOLESKY`` — range-space block elimination of the saddle matrix
                  ``[W Aᵀ; A C]`` (C diagonal ≤ 0) split at ``split``:
                  ``W = L₁L₁ᵀ``, ``X = L₁⁻¹Aᵀ``, ``S = XᵀX − C = L₂L₂ᵀ``;
                  the inertia from the two Cholesky factors' pivots.
* ``HYKKT``     — the Golub–Greif γ-augmented method: ``K_γ = W + γAᵀA``
                  factored once (``hykkt_backend="ldl"``: the blocked LDLᵀ,
                  K7 on the card; ``"native"``: ``cholesky_ex``), every
                  backsolve a float64 CG on the dual Schur complement; under
                  ``rr`` (the robust-restoration system) ``K_c = W +
                  Aᵀ(−C)⁻¹A`` with a direct solve.  Success of the factor is
                  the inertia certificate.
* ``LU``        — ``torch.linalg.lu_factor``; no inertia.
* ``QR``        — ``torch.linalg.qr``; no inertia.
* ``EVD``       — ``torch.linalg.eigh``; exact inertia.

``solve_mode="inverse"`` inverts the triangular factor once at
factorization time so that every backsolve is two mat-vecs; the solver's
default is ``"trisolve"`` on every device.  ``hykkt_backend=None`` takes
``"ldl"`` for a CUDA tensor and ``"native"`` on the CPU (the JAX package's
rule, with the tensor's device for its backend).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..utils.options import LinearSolver
from . import dense_kernels as _dense_kernels
from . import ldlt as _ldlt


class DenseFactor(NamedTuple):
    """Backend-specific factor payload: ``kind`` names the backend (and the
    solve mode), ``a``/``b`` hold its tensors, ``n`` the system size;
    ``meta`` holds HYKKT's host controls ``(cg_tol, cg_maxiter, rr)``."""

    kind: str
    a: torch.Tensor
    b: torch.Tensor
    n: int
    meta: tuple = ()


#: HYKKT's CG work since the last :func:`reset_cg_stats`: backsolves that
#: ran the CG, its iterations, and the host reads that steered it.
CG_STATS = {"solves": 0, "iterations": 0, "host_reads": 0}


def reset_cg_stats():
    for k in CG_STATS:
        CG_STATS[k] = 0


def _tri_inverse(L: torch.Tensor, unit: bool = False) -> torch.Tensor:
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False,
                                         unitriangular=unit)


def _cholesky(K: torch.Tensor):
    """Cholesky factor and ``info``; a failed factorization is all NaN, as
    XLA's cholesky returns it (its backsolve then ends the refinement at
    once, as in the JAX package; a partial factor would run the refinement
    to its cap)."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info == 0, L, torch.nan), info


def resolve_hykkt_backend(backend, device) -> str:
    """``None`` -> ``"ldl"`` (K7) on the card, ``"native"`` on the CPU."""
    if backend is None:
        return "native" if torch.device(device).type == "cpu" else "ldl"
    if backend not in ("ldl", "native"):
        raise ValueError(f"hykkt_backend must be 'ldl' or 'native', "
                         f"got {backend!r}")
    return backend


def _bchol_split(n: int, split) -> int:
    if split is None or not (0 < split < n):
        raise ValueError(
            "BLOCK_CHOLESKY factorizes the 2x2 augmented block structure and "
            "needs the primal/dual split (0 < split < n); it is only "
            "available through KKT systems that supply it (dense augmented)")
    return int(split)


def _bchol_factorize(K, n, split, inv):
    """Range-space block elimination of ``K = [W Aᵀ; A C]`` (C diagonal ≤
    0): ``W = L₁L₁ᵀ``, ``X = L₁⁻¹Aᵀ``, ``S = XᵀX − C = L₂L₂ᵀ``.  ``b``
    stacks X, L₂ (L₂⁻¹ in the inverse mode, where ``a`` is L₁⁻¹) and two
    flag rows: per Schur pivot whether it is valid, and whether L₁ is."""
    nw = _bchol_split(n, split)
    m = n - nw
    W, A, C = K[:nw, :nw], K[nw:, :nw], K[nw:, nw:]
    L1, _ = _cholesky(W)
    X = torch.linalg.solve_triangular(L1, A.T, upper=False)     # (nw, m)
    S = X.T @ X - C
    L2, _ = _cholesky(S)
    # rank-revealing pivot validity: an exactly singular block can round to
    # a finite Cholesky whose offending pivot sits at the cancellation noise
    # floor ~ sqrt(eps)·‖row‖, so "finite" alone cannot be the inertia
    # signal (False for NaN too)
    rtol = 4.0 * torch.finfo(K.dtype).eps ** 0.5

    def pivot_ok(L):
        rn = torch.sqrt((L * L).sum(1))
        return torch.diagonal(L) > rtol * rn

    l1_ok = pivot_ok(L1).all() & torch.isfinite(L1).all()
    l2_ok = pivot_ok(L2) & torch.isfinite(L2).all()
    flags = K.new_zeros((2, m))
    flags[0] = l2_ok.to(K.dtype)
    flags[1, 0] = l1_ok.to(K.dtype)
    if inv:
        return DenseFactor("bchol_inv", _tri_inverse(L1),
                           torch.cat([X, _tri_inverse(L2), flags]), n)
    return DenseFactor("bchol", L1, torch.cat([X, L2, flags]), n)


def _hykkt_factorize(K, n, split, inv, rr, gamma, cg_tol, cg_maxiter,
                     backend, block):
    """Golub–Greif γ-augmented factorization of ``K = [W Aᵀ; A C]`` (C
    diagonal ≤ 0), the HyKKT method of the reference's GPU ecosystem:
    ``K_γ = W + γAᵀA`` (SPD ⟺ the KKT signature is correct, so the factor's
    success is a sound inertia certificate), or under ``rr`` ``K_c = W +
    Aᵀ(−C)⁻¹A`` (the robust-restoration system's dual diagonal is strictly
    negative: direct elimination, no γ, no CG).  ``b`` stacks Aᵀ and four
    rows: c, γ, the success flag and the ``rr`` flag; ``meta`` carries the
    CG controls and ``rr`` for the host."""
    nw = _bchol_split(n, split)
    m = n - nw
    W, A = K[:nw, :nw], K[nw:, :nw]
    c = torch.diagonal(K[nw:, nw:])                              # (m,) ≤ 0
    if rr:
        gamma_eff = K.new_zeros(())
        Kg = W + (A.T / (-c)[None, :]) @ A
    else:
        # keep 1 + γc > 0 (c = −δ_c is a uniform tiny regularization)
        cmax = (-c).max()
        g = torch.tensor(gamma, dtype=K.dtype, device=K.device)
        gamma_eff = torch.where(cmax > 0, torch.minimum(g, 0.5 / cmax), g)
        Kg = W + gamma_eff * (A.T @ A)
    if backend == "ldl":
        # the blocked LDLᵀ (K7 on the card): K_γ is SPD when the inertia
        # condition holds, so all-positive pivots are the same certificate
        f = _dense_kernels.dense_ldlt(Kg, block=block)
        ok = torch.isfinite(f.d).all() & (f.d > 0).all()
        L = _tri_inverse(f.L, unit=True) if inv else f.L
        kind = "hykkt_ldl_inv" if inv else "hykkt_ldl"
        a = torch.cat([L, f.d[:, None]], 1)                     # (np, np+1)
    else:
        L, _ = _cholesky(Kg)
        ok = torch.isfinite(L).all()
        kind = "hykkt_inv" if inv else "hykkt"
        a = _tri_inverse(L) if inv else L
    rows = torch.stack([c, gamma_eff.expand(m), ok.to(K.dtype).expand(m),
                        K.new_full((m,), 1.0 if rr else 0.0)])
    return DenseFactor(kind, a, torch.cat([A.T, rows]), n,
                       meta=(float(cg_tol), int(cg_maxiter), bool(rr)))


def _hykkt_kg_solve(factor, B):
    """K_γ⁻¹ (or K_c⁻¹) applied to ``B (nw, k)`` through the stored
    factor."""
    if factor.kind.startswith("hykkt_ldl"):
        np_ = factor.a.shape[0]
        L, d = factor.a[:, :np_], factor.a[:, np_]
        nw = B.shape[0]
        if np_ != nw:
            B = torch.cat([B, B.new_zeros((np_ - nw, B.shape[1]))])
        d_div = _ldlt.pivot_div(d)[:, None]
        if factor.kind.endswith("_inv"):
            x = L.T @ ((L @ B) / d_div)
        else:
            z = torch.linalg.solve_triangular(L, B, upper=False,
                                              unitriangular=True)
            x = torch.linalg.solve_triangular(L.T, z / d_div, upper=True,
                                              unitriangular=True)
        return x[:nw]
    if factor.kind.endswith("_inv"):
        return factor.a.T @ (factor.a @ B)
    L = factor.a
    return torch.linalg.solve_triangular(
        L.T, torch.linalg.solve_triangular(L, B, upper=False), upper=True)


def _hykkt_solve(factor: DenseFactor, b):
    """Backsolve of the γ-augmented (CG) and condensed (``rr``, direct)
    modes.  The CG and the direct elimination run in float64 with the
    factor's precision only inside K_γ⁻¹: float64 keeps the Schur
    complement's arithmetic (which squares the conditioning) from flooring
    the outer refinement at the float32 noise level.  The CG is a host
    loop, steered by one host read per iteration."""
    nw = factor.b.shape[0] - 4
    fact_dtype = factor.b.dtype
    f64 = torch.float64
    At = factor.b[:nw].to(f64)                                   # Aᵀ (nw, m)
    c = factor.b[nw].to(f64)
    B1, B2 = b[:nw].to(f64), b[nw:].to(f64)
    cg_tol, cg_maxiter, rr = factor.meta

    def kg(B):
        return _hykkt_kg_solve(factor, B.to(fact_dtype)).to(f64)

    if rr:
        dinv = 1.0 / torch.where(c < 0, -c, 1.0)
        dx = kg(B1 + At @ (dinv[:, None] * B2))
        dy = dinv[:, None] * (At.T @ dx - B2)
        return torch.cat([dx, dy]).to(b.dtype)

    gamma = factor.b[nw + 1, 0].to(f64)
    scal = 1.0 + gamma * c                                       # > 0
    dvec = torch.sqrt(scal)[:, None]
    b1g = B1 + gamma * (At @ B2)
    rhs_s = dvec * (At.T @ kg(b1g) - B2)                         # symmetrized

    def S_op(v):
        return dvec * (At.T @ kg(At @ (dvec * v))) - c[:, None] * v

    # multi-right-hand-side CG with per-column steps; the reachable floor is
    # ~eps(fact) (K_γ⁻¹ runs at the factor's precision), so the target is
    # clamped there, and the loop exits on sustained stagnation (3
    # consecutive iterations that do not halve every residual)
    tol_eff = max(cg_tol, 64.0 * torch.finfo(fact_dtype).eps)
    rs = (rhs_s * rhs_s).sum(0)
    tol2 = (tol_eff * tol_eff) * torch.clamp_min(rs, torch.finfo(f64).tiny)
    y = torch.zeros_like(rhs_s)
    r, p = rhs_s, rhs_s
    slow = torch.zeros((), dtype=torch.int32, device=b.device)
    it = 0
    go = bool((rs > tol2).any())
    reads = 1
    while it < cg_maxiter and go:
        Ap = S_op(p)
        denom = (p * Ap).sum(0)
        alpha = torch.where(denom > 0,
                            rs / torch.where(denom > 0, denom, 1.0), 0.0)
        y = y + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        rs_new = (r * r).sum(0)
        beta = torch.where(rs > 0, rs_new / torch.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[None, :] * p
        stalled = (rs_new > 0.25 * rs).all()
        slow = torch.where(stalled, slow + 1, 0)
        rs = rs_new
        it += 1
        if it < cg_maxiter:
            go = bool((rs > tol2).any() & (slow < 3))
            reads += 1
    CG_STATS["solves"] += 1
    CG_STATS["iterations"] += it
    CG_STATS["host_reads"] += reads
    dy = y / dvec                                   # un-symmetrize ỹ = D·dy
    dx = kg(b1g - At @ (scal[:, None] * dy))
    return torch.cat([dx, dy]).to(b.dtype)


def factorize(K: torch.Tensor, solver: LinearSolver, block: int = 64,
              solve_mode: str = "trisolve", split: int = None,
              rr: bool = False, gamma: float = 1e4, cg_tol: float = 1e-8,
              cg_maxiter: int = 200, hykkt_backend: str = None) -> DenseFactor:
    """Factor the symmetric ``K`` with ``solver``.  ``split`` (the primal
    size nw), ``rr``, ``gamma``, ``cg_tol``, ``cg_maxiter`` and
    ``hykkt_backend`` are read by the range-space solvers only."""
    n = K.shape[0]
    inv = solve_mode == "inverse"
    if solver == LinearSolver.HYKKT:
        return _hykkt_factorize(
            K, n, split, inv, rr, gamma, cg_tol, cg_maxiter,
            resolve_hykkt_backend(hykkt_backend, K.device), block)
    if solver == LinearSolver.BLOCK_CHOLESKY:
        return _bchol_factorize(K, n, split, inv)
    if solver == LinearSolver.LDL:
        f = _dense_kernels.dense_ldlt(K, block=block)
        if inv:
            return DenseFactor("ldl_inv", _tri_inverse(f.L, unit=True), f.d, n)
        return DenseFactor("ldl", f.L, f.d, n)
    if solver == LinearSolver.CHOLESKY:
        L, info = _cholesky(K)
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
                solve_mode: str = "trisolve", device=None, split: int = None,
                hykkt_backend: str = None, cg_tol: float = 1e-8,
                cg_maxiter: int = 200) -> DenseFactor:
    """The all-zero factor of :func:`factorize`'s kind and shapes (the JAX
    package's ``zero_factor``): the persisted context of a solve that has
    factored nothing yet.  Its solves are not finite, as there."""
    inv = solve_mode == "inverse"

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if solver == LinearSolver.BLOCK_CHOLESKY:
        nw = _bchol_split(n, split)
        return DenseFactor("bchol_inv" if inv else "bchol", z(nw, nw),
                           z(n + 2, n - nw), n)
    if solver == LinearSolver.HYKKT:
        nw = _bchol_split(n, split)
        meta = (float(cg_tol), int(cg_maxiter), False)
        if resolve_hykkt_backend(hykkt_backend,
                                 device or "cpu") == "ldl":
            np_ = max(1, -(-nw // block)) * block
            return DenseFactor("hykkt_ldl_inv" if inv else "hykkt_ldl",
                               z(np_, np_ + 1), z(nw + 4, n - nw), n, meta)
        return DenseFactor("hykkt_inv" if inv else "hykkt", z(nw, nw),
                           z(nw + 4, n - nw), n, meta)
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
    raise ValueError(f"unsupported dense solver {solver}")


def solve(factor: DenseFactor, rhs: torch.Tensor) -> torch.Tensor:
    """Backsolve; ``rhs`` is (n,) or (n, k)."""
    kind = factor.kind
    squeeze = rhs.ndim == 1
    b = rhs[:, None] if squeeze else rhs
    if kind.startswith("hykkt"):
        x = _hykkt_solve(factor, b)
    elif kind in ("bchol", "bchol_inv"):
        nw = factor.a.shape[0]
        m = factor.n - nw
        X, L2 = factor.b[:nw], factor.b[nw:nw + m]
        b1, b2 = b[:nw], b[nw:]
        if kind == "bchol_inv":
            L1i = factor.a
            z1 = L1i @ b1
            y = L2.T @ (L2 @ (X.T @ z1 - b2))
            x1 = L1i.T @ (z1 - X @ y)
        else:
            L1 = factor.a
            z1 = torch.linalg.solve_triangular(L1, b1, upper=False)
            w2 = torch.linalg.solve_triangular(L2, X.T @ z1 - b2, upper=False)
            y = torch.linalg.solve_triangular(L2.T, w2, upper=True)
            x1 = torch.linalg.solve_triangular(L1.T, z1 - X @ y, upper=True)
        x = torch.cat([x1, y])
    elif kind == "ldl":
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
    if kind.startswith("hykkt"):
        # success of the K_γ (K_c) factor is equivalent to W ≻ 0 on null(A)
        # for a sufficient γ, the exact IPM inertia condition (Golub–Greif);
        # failure reports a wrong inertia -> δ_w ladder
        nw = factor.b.shape[0] - 4
        ok = bool(factor.b[nw + 2, 0] > 0.5)
        return (nw, 0, n - nw) if ok else (0, n, 0)
    if kind in ("bchol", "bchol_inv"):
        # valid W and Schur factors: signature (nw, 0, m) by Haynsworth; a
        # W-block failure is a wrong inertia (δ_w ladder); Schur pivot
        # failures alone are a rank-deficient Jacobian, reported as zeros
        # (δ_c regularization)
        nw = factor.a.shape[0]
        m = n - nw
        nz2, ok1 = torch.stack([(factor.b[nw + m] <= 0.5).sum(),
                                (factor.b[nw + m + 1, 0] > 0.5).long()]).tolist()
        return (nw, nz2, m - nz2) if ok1 else (0, n, 0)
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
