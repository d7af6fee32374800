"""Quasi-Newton Hessian approximations — port of
``madnlp_tpu/ipm/quasi_newton.py``.

* ``BFGS`` / ``DampedBFGS``: dense direct updates of an (n, n) matrix
  (quasi_newton.jl:112-130, 163-192; the damping is Nocedal & Wright's
  Procedure 18.2).
* ``CompactLBFGS``: the compact limited-memory form ``B = σI − UUᵀ + VVᵀ``
  (quasi_newton.jl:366-423) with the curvature skip and the reset after two
  skips in a row.  The memory is a fixed (n, p) pair ``Sk/Yk`` with the
  first ``mem`` columns active, oldest first, as in the JAX package.  A
  dense KKT system takes the formed (n, n) operator (:func:`lbfgs_update`),
  a sparse one the factored :class:`LowRankHessian`
  (:func:`lbfgs_update_compact`), whose diagonal is assembled into the KKT
  matrix and whose low-rank part every solve applies by
  Sherman–Morrison–Woodbury (``kkt/dense.py:DenseKKT._attach_smw``).

Plain torch on float64 tensors.  Each ``lax.cond`` of the JAX package whose
predicate is a scalar becomes a host branch on that scalar, read once.

``solve_batch`` keeps one memory per lane: a :class:`QNState` whose tensors
carry a leading lane axis and whose ``mem``, ``skipped`` and
``instantiated`` are ``(B,)`` numpy arrays, and a :class:`LowRankHessian`
with ``diag (B, n)`` and ``U``, ``V (B, n, p)``.
:func:`init_hessian_lowrank_lanes` and :func:`lbfgs_update_compact_lanes`
are the two steps over that lane axis, each on the lanes of a mask (the
JAX package's ``vmap`` of the same functions); a lane outside the mask,
and a lane whose update is skipped, keep their Hessian untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kkt.vec import lane_where
from ..utils.options import BFGSInitStrategy, QuasiNewtonOptions
from .kernels import _dot

EPS = float(torch.finfo(torch.float64).eps)


class LowRankHessian(NamedTuple):
    """Compact L-BFGS operator ``B = diag + V Vᵀ − U Uᵀ`` in factored form
    (reference: src/IPM/factorization.jl:76-140)."""

    diag: torch.Tensor   # (n,) σ (or the Gilbert–Lemaréchal start)
    U: torch.Tensor      # (n, p)
    V: torch.Tensor      # (n, p)


def lowrank_zeros(n: int, p: int, device, lanes: int = None) -> LowRankHessian:
    """The zero operator; with ``lanes``, one per lane."""
    lead = () if lanes is None else (lanes,)
    z = torch.zeros(lead + (n, p), dtype=torch.float64, device=device)
    return LowRankHessian(diag=z.new_zeros(lead + (n,)), U=z, V=z.clone())


class QNState(NamedTuple):
    """Fixed-shape quasi-Newton memory (a field of the solver state)."""

    last_x: torch.Tensor    # (n,)
    last_g: torch.Tensor    # (n,)
    last_jv: torch.Tensor   # (n,) Jᵀy at last_x
    Sk: torch.Tensor        # (n, p)
    Yk: torch.Tensor        # (n, p)
    mem: int = 0            # columns in use
    skipped: int = 0        # consecutive skipped updates
    instantiated: bool = False   # BFGS: B re-initialized at the first update


def qn_zeros(n: int, p: int, device, lanes: int = None) -> QNState:
    """The empty memory; with ``lanes``, one per lane."""
    lead = () if lanes is None else (lanes,)

    def z(*shape):
        return torch.zeros(lead + shape, dtype=torch.float64, device=device)

    qn = QNState(last_x=z(n), last_g=z(n), last_jv=z(n), Sk=z(n, p),
                 Yk=z(n, p))
    if lanes is None:
        return qn
    return qn._replace(mem=np.zeros(lanes, dtype=np.int64),
                       skipped=np.zeros(lanes, dtype=np.int64),
                       instantiated=np.zeros(lanes, dtype=bool))



def curvature(strategy: BFGSInitStrategy, sk, yk):
    """σ-initialization strategies (quasi_newton.jl:48-61), a 0-d tensor
    (a ``(B,)`` one for pairs with a lane axis)."""
    sy = _dot(sk, yk)
    ss = _dot(sk, sk)
    yy = _dot(yk, yk)
    if strategy == BFGSInitStrategy.SCALAR1:
        return sy / ss
    if strategy == BFGSInitStrategy.SCALAR2:
        return yy / sy
    if strategy == BFGSInitStrategy.SCALAR3:
        return ((sy / ss) + (yy / sy)) / 2.0
    if strategy == BFGSInitStrategy.SCALAR4:
        return torch.sqrt((sy / ss) * (yy / sy))
    return sk.new_ones(sk.shape[:-1])      # CONSTANT


def _gilbert_lemarechal_rho(g0, f0: float) -> float:
    norm_g0 = float(torch.dot(g0, g0))
    if norm_g0 < EPS ** 0.5:
        return 1.0
    return 1.0 / norm_g0 if abs(f0) < EPS else abs(f0) / norm_g0


def init_hessian_dense(n: int, g0, f0: float, init_value: float = 1.0):
    """Gilbert–Lemaréchal initial estimate (quasi_newton.jl:194-206)."""
    rho = _gilbert_lemarechal_rho(g0, f0)
    return 2.0 * rho * init_value * torch.eye(n, dtype=torch.float64,
                                              device=g0.device)


def init_hessian_lowrank(lr: LowRankHessian, g0, f0: float,
                         init_value: float = 1.0) -> LowRankHessian:
    """The same start in the low-rank form's diagonal storage."""
    rho = _gilbert_lemarechal_rho(g0, f0)
    return LowRankHessian(diag=torch.full_like(lr.diag, 2.0 * rho * init_value),
                          U=torch.zeros_like(lr.U), V=torch.zeros_like(lr.V))


def bfgs_update(Bk, qn: QNState, sk, yk, damped: bool):
    """Dense (damped) BFGS update; returns ``(Bk', qn')``."""
    yksk = torch.dot(sk, yk)
    if not damped and float(yksk) < 1e-8:
        # plain BFGS skips the update on negative curvature
        # (quasi_newton.jl:113-116)
        return Bk, qn
    n = Bk.shape[0]
    if not qn.instantiated:
        # re-initialize B lazily at the first update
        Bk = torch.eye(n, dtype=Bk.dtype, device=Bk.device) * (
            yksk / torch.dot(sk, sk))
    bsk = Bk @ sk
    sBs = torch.dot(sk, bsk)
    if damped:
        # Procedure 18.2 (quasi_newton.jl:176-191)
        theta = torch.where(yksk < 0.2 * sBs, 0.8 * sBs / (sBs - yksk), 1.0)
        rk = theta * yk + (1.0 - theta) * bsk
        Bk = (Bk - torch.outer(bsk, bsk) / sBs
              + torch.outer(rk, rk) / torch.dot(rk, sk))
    else:
        Bk = Bk - torch.outer(bsk, bsk) / sBs + torch.outer(yk, yk) / yksk
    return Bk, qn._replace(instantiated=True)


def lbfgs_update(Bk, qn: QNState, sk, yk, opts: QuasiNewtonOptions):
    """Compact L-BFGS update forming the dense operator (dense KKT
    systems); returns ``(Bk', qn')``."""
    n = Bk.shape[0]

    def form(_, s, U, V):
        return (s * torch.eye(n, dtype=U.dtype, device=U.device)
                - U @ U.T + V @ V.T)

    return _lbfgs_update_generic(Bk, qn, sk, yk, opts, form)


def lbfgs_update_compact(lr: LowRankHessian, qn: QNState, sk, yk,
                         opts: QuasiNewtonOptions):
    """Compact L-BFGS update kept in factored low-rank form (sparse KKT
    systems, SMW at solve time); returns ``(LowRankHessian', qn')``."""

    def form(lr, s, U, V):
        return LowRankHessian(diag=s.expand_as(lr.diag).clone(), U=U, V=V)

    return _lbfgs_update_generic(lr, qn, sk, yk, opts, form)


def _lbfgs_update_generic(Bk, qn: QNState, sk, yk, opts: QuasiNewtonOptions,
                          form):
    """The compact L-BFGS machinery shared by both forms
    (quasi_newton.jl:366-423 over a fixed-size masked memory);
    ``form(hess, sigma, U, V)`` builds the output representation."""
    n, p = qn.Sk.shape
    norm_s, norm_y, sy = torch.stack([torch.linalg.vector_norm(sk),
                                      torch.linalg.vector_norm(yk),
                                      torch.dot(sk, yk)]).tolist()
    if (norm_s < 100 * EPS or norm_y < 100 * EPS
            or sy < EPS ** 0.5 * norm_s * norm_y):
        skipped = qn.skipped + 1
        if skipped >= 2:
            return Bk, qn._replace(
                Sk=torch.zeros_like(qn.Sk), Yk=torch.zeros_like(qn.Yk),
                mem=0, skipped=0, last_jv=torch.zeros_like(qn.last_jv))
        return Bk, qn._replace(skipped=skipped)

    def insert(M, v):
        # history left-aligned, oldest first; when full, shift left
        if qn.mem >= p:
            M = torch.roll(M, -1, dims=1)
            M[:, p - 1] = v
        else:
            M = M.clone()
            M[:, qn.mem] = v
        return M

    Sk = insert(qn.Sk, sk)
    Yk = insert(qn.Yk, yk)
    mem = min(qn.mem + 1, p)
    active = torch.arange(p, device=sk.device) < mem

    sigma = torch.clamp(curvature(opts.init_strategy, sk, yk),
                        opts.sigma_min, opts.sigma_max)
    SY = Sk.T @ Yk                                    # (p, p)
    Dk = torch.where(active, torch.diagonal(SY), 1.0)
    mask2 = active[:, None] & active[None, :]
    Lk = torch.where(mask2, torch.tril(SY, diagonal=-1), 0.0)  # strict lower
    delta = 1.0 / torch.sqrt(Dk)
    DkLk = delta[:, None] * Lk.T                      # D^{-1/2} Lᵀ
    Mk = sigma * (Sk.T @ Sk) + DkLk.T @ DkLk
    Mk = Mk + torch.diag(torch.where(active, 0.0, 1.0))   # identity padding
    Jk = torch.linalg.cholesky(Mk)
    V = Yk * delta[None, :]
    U = sigma * Sk + V @ DkLk
    U = torch.linalg.solve_triangular(Jk, U.T, upper=False).T   # U Jk⁻ᵀ
    qn = qn._replace(Sk=Sk, Yk=Yk, mem=mem, skipped=0)
    return form(Bk, sigma, U, V), qn


# -- over a lane axis (solve_batch) ------------------------------------------


def init_hessian_lowrank_lanes(lr: LowRankHessian, g0, f0, init_value: float,
                               lanes) -> LowRankHessian:
    """:func:`init_hessian_lowrank` of the lanes in ``lanes`` (numpy bool
    (B,)); ``g0 (B, n)``, ``f0 (B,)`` numpy."""
    norm_g0 = _dot(g0, g0).cpu().numpy()
    f0 = np.abs(np.asarray(f0, dtype=np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(norm_g0 < EPS ** 0.5, 1.0,
                       np.where(f0 < EPS, 1.0 / norm_g0, f0 / norm_g0))
    diag = torch.as_tensor(2.0 * rho * init_value, device=g0.device)
    on = torch.as_tensor(np.asarray(lanes, dtype=bool), device=g0.device)
    return LowRankHessian(
        diag=lane_where(on, diag[:, None].expand_as(lr.diag), lr.diag),
        U=lane_where(on, torch.zeros_like(lr.U), lr.U),
        V=lane_where(on, torch.zeros_like(lr.V), lr.V))


def lbfgs_update_compact_lanes(lr: LowRankHessian, qn: QNState, sk, yk,
                               opts: QuasiNewtonOptions, lanes):
    """:func:`lbfgs_update_compact` of the lanes in ``lanes`` (numpy bool
    (B,)), each with its own memory, skip test and reset; ``sk``, ``yk``
    ``(B, n)``.  Returns ``(LowRankHessian', qn')``."""
    B, n, p = qn.Sk.shape
    dev = sk.device
    norm_s, norm_y, sy = torch.stack([
        torch.linalg.vector_norm(sk, dim=-1),
        torch.linalg.vector_norm(yk, dim=-1), _dot(sk, yk)]).cpu().numpy()
    lanes = np.asarray(lanes, dtype=bool)
    skip = lanes & ((norm_s < 100 * EPS) | (norm_y < 100 * EPS)
                    | (sy < EPS ** 0.5 * norm_s * norm_y))
    upd = lanes & ~skip
    skipped = np.where(skip, qn.skipped + 1, qn.skipped)
    reset = skip & (skipped >= 2)
    skipped = np.where(reset | upd, 0, skipped)
    mem = np.where(upd, np.minimum(qn.mem + 1, p), np.where(reset, 0, qn.mem))
    on_upd = torch.as_tensor(upd, device=dev)
    on_reset = torch.as_tensor(reset, device=dev)

    # history left-aligned, oldest first; when full, shift left
    full = torch.as_tensor(qn.mem >= p, device=dev)[:, None, None]
    col = torch.as_tensor(np.minimum(qn.mem, p - 1), device=dev)
    slot = (torch.arange(p, device=dev) == col[:, None])[:, None, :]

    def insert(M, v):
        M = torch.where(full, torch.roll(M, -1, dims=-1), M)
        return torch.where(slot, v[..., None], M)

    Sk = insert(qn.Sk, sk)
    Yk = insert(qn.Yk, yk)
    active = torch.arange(p, device=dev) < torch.as_tensor(mem, device=dev)[:, None]

    sigma = torch.clamp(curvature(opts.init_strategy, sk, yk),
                        opts.sigma_min, opts.sigma_max)
    St = Sk.transpose(-1, -2)
    SY = St @ Yk                                             # (B, p, p)
    Dk = torch.where(active, torch.diagonal(SY, dim1=-2, dim2=-1), 1.0)
    mask2 = active[:, :, None] & active[:, None, :]
    Lk = torch.where(mask2, torch.tril(SY, diagonal=-1), 0.0)
    delta = 1.0 / torch.sqrt(Dk)
    DkLk = delta[..., None] * Lk.transpose(-1, -2)
    Mk = sigma[:, None, None] * (St @ Sk) + DkLk.transpose(-1, -2) @ DkLk
    Mk = Mk + torch.diag_embed(torch.where(active, 0.0, 1.0))
    # the lanes that do not update factor the identity instead
    Mk = lane_where(on_upd, Mk, torch.eye(p, dtype=Mk.dtype, device=dev)
                     .expand_as(Mk))
    Jk = torch.linalg.cholesky(Mk)
    V = Yk * delta[:, None, :]
    U = sigma[:, None, None] * Sk + V @ DkLk
    U = torch.linalg.solve_triangular(Jk, U.transpose(-1, -2),
                                      upper=False).transpose(-1, -2)
    lr = LowRankHessian(
        diag=lane_where(on_upd, sigma[:, None].expand_as(lr.diag), lr.diag),
        U=lane_where(on_upd, U, lr.U), V=lane_where(on_upd, V, lr.V))
    zero = torch.zeros_like(qn.Sk)
    qn = qn._replace(
        Sk=lane_where(on_upd, Sk, lane_where(on_reset, zero, qn.Sk)),
        Yk=lane_where(on_upd, Yk, lane_where(on_reset, zero, qn.Yk)),
        last_jv=lane_where(on_reset, torch.zeros_like(qn.last_jv),
                            qn.last_jv),
        mem=mem, skipped=skipped)
    return lr, qn
