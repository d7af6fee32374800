"""Richardson iterative refinement over a KKT operator — port of
``madnlp_tpu/ops/refine.py:solve_refine``.

Repeat ``x += K⁻¹(b - K x)`` until ``‖r‖ / (min(‖x‖, 1e6‖b‖) + ‖b‖) < tol``
or the iteration cap is hit; success means the ratio beat
``acceptable_tol``.  The loop runs on the host: one host read of the two
norms per sweep.  :func:`solve_refine_batched` runs the same loop for a
batch of lanes (the vmapped ``lax.while_loop`` of the JAX package): each
lane stops on its own ratio, and a sweep solves only the lanes still
running.

:func:`solve_gmres` is the refinement of ``iterator="gmres"``: the JAX
package's preconditioned GMRES (``jax.scipy.sparse.linalg.gmres`` with
``solve_method="batched"``), the KKT operator as the mat-vec and the
current factorization as the preconditioner.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kkt.vec import KKTVec, lane_where, norm_inf


def _ratio(norm_w, norm_x, norm_b):
    den = min(norm_x, 1e6 * norm_b) + norm_b
    if den == 0.0:
        return math.nan if norm_w == 0.0 else math.inf
    return norm_w / den


def solve_refine(solve_fn, mul_fn, b: KKTVec, max_iter: int, tol: float,
                 acceptable_tol: float):
    """Returns ``(x, converged, iters)``."""
    norm_b = float(norm_inf(b))
    x = KKTVec(*(torch.zeros_like(a) for a in b))
    w = b
    ir = 0
    ratio = prev = math.inf
    norm_w = norm_b
    while True:
        # Stagnation early-exit (as in the JAX package): with a
        # reduced-precision factor the residual plateaus long before `tol`;
        # once the ratio is acceptable and improving by <4x per sweep, more
        # sweeps are wasted backsolves.
        stalled = (ratio > 0.25 * prev) and (ratio < acceptable_tol)
        if not (ir < max_iter and ratio >= tol and not stalled):
            break
        dx = solve_fn(w)
        x = x.axpy(1.0, dx)
        kx = mul_fn(x)
        w = KKTVec(*(bb - kk for bb, kk in zip(b, kx)))
        norm_w, norm_x = torch.stack([norm_inf(w), norm_inf(x)]).tolist()
        prev, ratio = ratio, _ratio(norm_w, norm_x, norm_b)
        ir += 1
    converged = ratio < acceptable_tol
    # Inconsistent-singular guard: a genuine solve must at least reduce
    # the residual.
    converged = converged and (norm_w <= 0.999 * norm_b)
    # b == 0 -> x = 0 is exact.
    converged = converged or norm_b == 0.0
    return x, converged, ir


def solve_refine_batched(solve_fn, mul_fn, b: KKTVec, active, max_iter: int,
                         tol, acceptable_tol: float):
    """:func:`solve_refine` lane by lane over ``b`` (B, ·) for the lanes
    that ``active`` (numpy bool (B,)) selects; ``tol`` is a float or a
    ``(B,)`` array.  ``solve_fn(w, run)`` solves the lanes of the numpy
    mask ``run`` (one batched backsolve per sweep).  A lane that stops
    keeps its ``x``.  Returns ``(x, converged (B,), iters (B,))``; lanes
    outside ``active`` report 0 sweeps and are not converged."""
    B = len(active)
    tol = np.broadcast_to(np.asarray(tol, dtype=np.float64), (B,))
    norm_b = norm_inf(b).cpu().numpy()
    x = KKTVec(*(torch.zeros_like(a) for a in b))
    w = b
    ir = np.zeros(B, dtype=np.int64)
    ratio = np.full(B, math.inf)
    prev = np.full(B, math.inf)
    norm_w = norm_b.copy()
    run = np.asarray(active, dtype=bool).copy()
    while True:
        # the stagnation early-exit of solve_refine, per lane
        stalled = (ratio > 0.25 * prev) & (ratio < acceptable_tol)
        run &= (ir < max_iter) & (ratio >= tol) & ~stalled
        if not run.any():
            break
        on = torch.as_tensor(run, device=b.xp.device)
        dx = solve_fn(w, run)
        x = lane_where(on, x.axpy(1.0, dx), x)
        kx = mul_fn(x)
        w = lane_where(on, KKTVec(*(bb - kk for bb, kk in zip(b, kx))), w)
        nw_, nx_ = torch.stack([norm_inf(w), norm_inf(x)]).cpu().numpy()
        for i in np.flatnonzero(run):
            prev[i], ratio[i] = ratio[i], _ratio(nw_[i], nx_[i], norm_b[i])
            norm_w[i] = nw_[i]
        ir[run] += 1
    converged = (ratio < acceptable_tol) & (norm_w <= 0.999 * norm_b)
    converged |= norm_b == 0.0
    return x, converged & np.asarray(active, dtype=bool), ir


_EPS = float(torch.finfo(torch.float64).eps)


def _safe_normalize(x, thresh=None):
    """(x / ‖x‖₂, ‖x‖₂), or (0, 0) where ‖x‖₂ is not above ``thresh``
    (default: the dtype's epsilon), as ``jax.scipy.sparse.linalg`` takes
    it; the norm is a host float."""
    norm = torch.linalg.vector_norm(x)
    if float(norm) > (_EPS if thresh is None else thresh):
        return x / norm, float(norm)
    return torch.zeros_like(x), 0.0


def _gmres_restart(A, M, b, x0, unit_residual, residual_norm, restart):
    """One restart of GMRES, as ``_gmres_batched`` (the JAX package's
    "batched" method): ``restart`` Arnoldi steps on ``M∘A`` (fewer on a
    breakdown), each one pass of classical Gram–Schmidt against all
    ``restart + 1`` columns of V, then the least-squares problem of the
    Hessenberg matrix by its normal equations (Cholesky)."""
    V = unit_residual.new_zeros((unit_residual.shape[0], restart + 1))
    V[:, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=V.dtype, device=V.device)
    k, breakdown = 0, False
    while k < restart and not breakdown:
        v = M(A(V[:, k]))
        _, v_norm_0 = _safe_normalize(v)
        h = V.T @ v
        v = v - V @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=_EPS * v_norm_0)
        V[:, k + 1] = unit_v
        h[k + 1] = v_norm_1
        H[k, :] = h
        breakdown = v_norm_1 == 0.0
        k += 1
    beta = H.new_zeros(restart + 1)
    beta[0] = residual_norm
    L, info = torch.linalg.cholesky_ex(H @ H.T)
    if int(info):
        L = torch.full_like(L, math.nan)   # as XLA's failed Cholesky
    y = torch.cholesky_solve((H @ beta)[:, None], L)[:, 0]
    x = x0 + V[:, :-1] @ y
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def solve_gmres(solve_fn, mul_fn, b: KKTVec, max_iter: int, tol: float,
                acceptable_tol: float):
    """Preconditioned GMRES refinement (the reference's ``KrylovIterator``,
    lib/MadNLPKrylov/src/MadNLPKrylov.jl:14-100): ``x`` from zero, at most
    ``max_iter`` restarts of ``min(20, max_iter)`` Arnoldi steps on the
    left-preconditioned system ``K⁻¹K x = K⁻¹b`` while the preconditioned
    residual's 2-norm exceeds ``tol·‖b‖₂``; then the refinement's own
    success test on the true residual.  Returns ``(x, converged,
    max_iter)``: the JAX package counts ``max_iter`` backsolves, whatever
    GMRES did."""
    sizes = [a.shape[0] for a in b]

    def unflat(v):
        return KKTVec(*torch.split(v, sizes))

    def A(v):
        return torch.cat(list(mul_fn(unflat(v))))

    def M(v):
        return torch.cat(list(solve_fn(unflat(v))))

    bf = torch.cat(list(b))
    restart = min(min(20, max(1, max_iter)), bf.shape[0])
    atol = max(tol * float(torch.linalg.vector_norm(bf)), 0.0)
    x = torch.zeros_like(bf)
    unit_residual, residual_norm = _safe_normalize(M(bf - A(x)))
    k = 0
    while k < max_iter and residual_norm > atol:
        x, unit_residual, residual_norm = _gmres_restart(
            A, M, bf, x, unit_residual, residual_norm, restart)
        k += 1
    xk = unflat(x)
    r = KKTVec(*(bb - kk for bb, kk in zip(b, mul_fn(xk))))
    norm_r, norm_x, norm_b = torch.stack(
        [norm_inf(r), norm_inf(xk), norm_inf(b)]).tolist()
    converged = (_ratio(norm_r, norm_x, norm_b) < acceptable_tol
                 and norm_r <= 0.999 * norm_b) or norm_b == 0.0
    return xk, converged, max_iter


def _safe_normalize_lanes(x, thresh):
    """:func:`_safe_normalize` of each lane of ``x (B, N)``; ``thresh`` a
    ``(B,)`` array.  Returns the unit lanes and the ``(B,)`` host norms."""
    norm = torch.linalg.vector_norm(x, dim=-1)
    host = norm.cpu().numpy()
    big = host > thresh
    on = torch.as_tensor(big, device=x.device)[:, None]
    unit = torch.where(on, x / norm[:, None], 0.0)
    return unit, np.where(big, host, 0.0)


def _gmres_restart_lanes(A, M, b, x0, unit_residual, residual_norm, restart,
                         lanes):
    """:func:`_gmres_restart` of the lanes in ``lanes`` (numpy bool (B,)),
    each with its own breakdown; ``M(v, run)`` preconditions the lanes of
    ``run``.  Returns the new ``x``, unit residual and residual norms of
    every lane (the others' as they were)."""
    B, N = unit_residual.shape
    dev = unit_residual.device
    V = unit_residual.new_zeros((B, N, restart + 1))
    V[:, :, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=V.dtype,
                  device=dev).expand(B, -1, -1).clone()
    go = lanes.copy()
    k = 0
    while k < restart and go.any():
        on = torch.as_tensor(go, device=dev)
        v = M(A(V[:, :, k]), go)
        _, v_norm_0 = _safe_normalize_lanes(v, _EPS)
        h = (V.transpose(-1, -2) @ v[..., None])[..., 0]
        v = v - (V @ h[..., None])[..., 0]
        unit_v, v_norm_1 = _safe_normalize_lanes(v, _EPS * v_norm_0)
        V[:, :, k + 1] = torch.where(on[:, None], unit_v, V[:, :, k + 1])
        h[:, k + 1] = torch.as_tensor(v_norm_1, device=dev)
        H[:, k, :] = torch.where(on[:, None], h, H[:, k, :])
        go &= v_norm_1 != 0.0
        k += 1
    beta = H.new_zeros((B, restart + 1))
    beta[:, 0] = torch.as_tensor(residual_norm, device=dev)
    L, info = torch.linalg.cholesky_ex(H @ H.transpose(-1, -2))
    # as XLA's failed Cholesky
    L = torch.where((info != 0)[:, None, None], math.nan, L)
    y = torch.cholesky_solve((H @ beta[..., None]), L)[..., 0]
    x = x0 + (V[:, :, :-1] @ y[..., None])[..., 0]
    unit, norm = _safe_normalize_lanes(M(b - A(x), lanes), _EPS)
    on = torch.as_tensor(lanes, device=dev)[:, None]
    return (torch.where(on, x, x0), torch.where(on, unit, unit_residual),
            np.where(lanes, norm, residual_norm))


def solve_gmres_batched(solve_fn, mul_fn, b: KKTVec, active, max_iter: int,
                        tol: float, acceptable_tol: float):
    """:func:`solve_gmres` lane by lane over ``b`` (B, ·) for the lanes
    that ``active`` (numpy bool (B,)) selects, each with its own restarts
    and breakdowns (the JAX package's ``vmap`` of its GMRES);
    ``solve_fn(w, run)`` preconditions the lanes of ``run`` (one batched
    backsolve per Arnoldi step).  Returns ``(x, converged (B,), iters
    (B,))``: ``max_iter`` backsolves counted per active lane, as the
    single solve counts them."""
    active = np.asarray(active, dtype=bool)
    sizes = [a.shape[-1] for a in b]

    def unflat(v):
        return KKTVec(*torch.split(v, sizes, dim=-1))

    def A(v):
        return torch.cat(list(mul_fn(unflat(v))), -1)

    def M(v, run):
        return torch.cat(list(solve_fn(unflat(v), run)), -1)

    bf = torch.cat(list(b), -1)
    restart = min(min(20, max(1, max_iter)), bf.shape[-1])
    atol = np.maximum(
        tol * torch.linalg.vector_norm(bf, dim=-1).cpu().numpy(), 0.0)
    x = torch.zeros_like(bf)
    unit_residual, residual_norm = _safe_normalize_lanes(
        M(bf - A(x), active), _EPS)
    k = np.zeros(len(active), dtype=np.int64)
    run = active & (k < max_iter) & (residual_norm > atol)
    while run.any():
        x, unit_residual, residual_norm = _gmres_restart_lanes(
            A, M, bf, x, unit_residual, residual_norm, restart, run)
        k[run] += 1
        run &= (k < max_iter) & (residual_norm > atol)
    xk = unflat(x)
    r = KKTVec(*(bb - kk for bb, kk in zip(b, mul_fn(xk))))
    norm_r, norm_x, norm_b = torch.stack(
        [norm_inf(r), norm_inf(xk), norm_inf(b)]).cpu().numpy()
    converged = np.array([
        (_ratio(nr, nx, nb) < acceptable_tol and nr <= 0.999 * nb)
        or nb == 0.0 for nr, nx, nb in zip(norm_r, norm_x, norm_b)])
    return (xk, converged & active,
            np.where(active, max_iter, 0).astype(np.int64))
