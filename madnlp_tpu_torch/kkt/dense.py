"""Dense reduced augmented KKT system — port of
``madnlp_tpu/kkt/dense.py:DenseKKT``, and the base of
:class:`..sparse.SparseKKT` and :class:`..condensed_dense.DenseCondensedKKT`.

The system is the reduced augmented form (KKTsystem.jl:38-58)

    [ W + Σx + δwI      0          Aₑᵀ  Aᵢᵀ ] [Δx]
    [ 0                Σs + δwI     0   -I  ] [Δs]
    [ Aₑ                0          -δcI  0  ] [Δy]
    [ Aᵢ               -I           0  -δcI ] [Δz]

stored as one (nw+m, nw+m) symmetric dense matrix and built fresh every
factorization, with the bound duals eliminated and recovered analytically
(kernels.jl:182-204), positive-slack convention ``dl = x - xl``,
``du = xu - x``.  The matrix is equilibrated by a congruence D·K·D, which
keeps the inertia: 3 Ruiz sweeps (``kkt_scaling="ruiz"``), the analytic
√Ξ scaling of the K2.5 formulation (``"k25"``) or none; cast to
``opts.dtype`` and factored by :mod:`..ops.dense_solvers` (the
range-space solvers BLOCK_CHOLESKY and HYKKT split it at nw and read the
robust-restoration flag ``rr``); the refinement operator stays float64,
and so does the refinement: Richardson, or GMRES (``iterator="gmres"``,
:func:`..ops.refine.solve_gmres`).

Under compact L-BFGS on a sparse KKT system the factored matrix carries
only the Hessian's diagonal; :meth:`DenseKKT._attach_smw` adds the
Sherman–Morrison–Woodbury payload of the low-rank part at factorization
time and every backsolve applies it (reference:
src/IPM/factorization.jl:76-140).

The diagonals, the reduction and recovery of the bound-dual rows and the
refined solve with μ-aware stopping are shared with the subclasses, and
also take a batch: vectors and context with a leading lane axis
``(B, ·)``, an ``active`` lane mask (numpy bool ``(B,)``) that selects the
lanes a backsolve or refinement runs for, and a per-lane μ (the banded
sparse path's ``solve_batch``; dense storage runs one system).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import dense_solvers as ds
from ..ops.refine import (
    solve_gmres,
    solve_gmres_batched,
    solve_refine,
    solve_refine_batched,
)
from ..utils.options import LinearSolver, MadNLPOptions
from .vec import KKTVec, lane_where

_FACT_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def _later(what: str):
    return NotImplementedError(f"{what} comes in a later slice of the port")


class EquilibratedFactor(NamedTuple):
    """Factor of D·K·D plus the scaling vector d (original ordering).
    ``smw`` is the optional Sherman–Morrison–Woodbury payload ``(E, T,
    S_lu)`` of a compact L-BFGS Hessian: the factored matrix is K₀ (the
    σ-diagonal only) and every solve is corrected as
    ``x = x₀ − T·S⁻¹·Eᵀx₀`` with ``T = K₀⁻¹Ẽ``, ``S = C + ẼᵀK₀⁻¹Ẽ``,
    ``C = diag(−I, I)``, ``Ẽ = [U V]`` zero-padded to the system size,
    ``S_lu`` the LU factor and pivots of S."""

    inner: object
    d: torch.Tensor
    smw: tuple = None
    opband: object = None   # unscaled f64 operator band (banded path): the
    # iterative-refinement operator as block-banded mat-vecs


class KKTContext(NamedTuple):
    """Per-iteration numeric payload of the KKT system."""

    hess: torch.Tensor      # (n, n) Hessian, or its (nnzh,) COO values
    jac: torch.Tensor       # (m, nw) augmented Jacobian [J, -E], or its
    #                         (nnzj + ns,) COO values
    pr_diag: torch.Tensor   # (nw,) primal diagonal  Σ + reg
    du_diag: torch.Tensor   # (m,) dual diagonal (≤ 0)
    reg: torch.Tensor       # (nw,) primal regularization part of pr_diag
    dl: torch.Tensor        # (nw,) masked x - xl
    du_: torch.Tensor       # (nw,) masked xu - x
    zl: torch.Tensor        # (nw,)
    zu: torch.Tensor        # (nw,)
    factor: EquilibratedFactor


class DenseKKT:
    """Static wrapper: holds the problem structure + options, provides
    functions over :class:`KKTContext`."""

    def __init__(self, prob, opts: MadNLPOptions):
        self.prob = prob
        self.opts = opts
        self.solver = opts.linear_solver
        self.device = prob.device
        if opts.dtype not in _FACT_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_FACT_DTYPES)}")
        # mixed precision: factorize in opts.dtype, keep the operator and
        # the Richardson refinement in f64
        self.fact_dtype = _FACT_DTYPES[opts.dtype]
        self.lb = torch.as_tensor(prob.lb_mask, device=self.device)
        self.ub = torch.as_tensor(prob.ub_mask, device=self.device)
        if prob.m == 0 and self.solver in (LinearSolver.BLOCK_CHOLESKY,
                                           LinearSolver.HYKKT):
            # no dual block to eliminate: plain Cholesky is the same method
            self.solver = LinearSolver.CHOLESKY
        # the TPU's "inverse" default stays behind: backsolves are
        # triangular solves on every device unless the caller asks
        self.solve_mode = opts.solve_mode or "trisolve"

    # -- dense storage: equilibrate and factorize ---------------------------

    def _factorize_matrix(self, K, d_analytic=None, split=None, rr=False):
        """Factorize D·K·D, the scaled matrix in ``opts.dtype``, with D by
        ``opts.kkt_scaling``: ``"k25"`` takes ``d_analytic``, the K2.5
        scaling the KKT system supplies (a system that supplies none is
        not scaled); ``"ruiz"`` 3 Ruiz sweeps (d ← d/√(row-inf-norm); zero
        rows keep d = 1); anything else none.  ``split`` (the primal block's
        size) and ``rr`` (the robust-restoration system) reach the
        range-space solvers, BLOCK_CHOLESKY and HYKKT; HYKKT's γ is
        ``opts.hykkt_gamma``, by default 1e4 for a float64 factor and 1e3
        for float32."""
        mode = self.opts.kkt_scaling
        d = K.new_ones(K.shape[0])
        if mode == "k25" and d_analytic is not None:
            d = d_analytic
        elif mode == "ruiz":
            for _ in range(3):
                r = (K * (d[:, None] * d[None, :])).abs().amax(1)
                d = torch.where(r > 0.0, d / torch.sqrt(torch.clamp_min(r, 1e-32)),
                                1.0)
        Kf = (K * (d[:, None] * d[None, :])).to(self.fact_dtype)
        gamma = self.opts.hykkt_gamma
        if gamma is None:
            gamma = 1e4 if self.fact_dtype == torch.float64 else 1e3
        inner = ds.factorize(Kf, self.solver,
                             block=self.opts.ldl_block_size or 64,
                             solve_mode=self.solve_mode, split=split, rr=rr,
                             gamma=gamma, cg_tol=self.opts.hykkt_cg_tol,
                             cg_maxiter=self.opts.hykkt_cg_maxiter,
                             hykkt_backend=self._hykkt_backend())
        return EquilibratedFactor(inner=inner, d=d)

    def _split(self):
        """Primal/dual block boundary for the range-space factorizations."""
        if self.solver in (LinearSolver.BLOCK_CHOLESKY, LinearSolver.HYKKT):
            return self.prob.nw
        return None

    def _hykkt_backend(self) -> str:
        """``opts.hykkt_backend``, or by the device: ``"ldl"`` (K_γ through
        K7) on the card, ``"native"`` (``cholesky_ex``) on the CPU."""
        return ds.resolve_hykkt_backend(self.opts.hykkt_backend, self.device)

    def _k25_scaling(self, dl, du_, size_dual: int):
        """√Ξ over the primal block, 1 over the dual block
        (kernels.jl:61-63 scaling_factor)."""
        s = (torch.where(self.lb, torch.sqrt(dl), 1.0)
             * torch.where(self.ub, torch.sqrt(du_), 1.0))
        return torch.cat([s, s.new_ones(s.shape[:-1] + (size_dual,))], -1)

    def _backsolve(self, factor, rhs, active=None):
        # K x = b  ⟺  (DKD)(D⁻¹x) = D b
        if active is not None:
            raise _later("batched dense KKT storage")
        d = factor.d if rhs.ndim == 1 else factor.d[:, None]
        scaled = (d * rhs).to(self.fact_dtype)
        return self._apply_smw(factor,
                               d * ds.solve(factor.inner, scaled).to(rhs.dtype))

    # -- compact L-BFGS low-rank correction (SMW) ---------------------------

    def _apply_smw(self, factor, x0):
        """The SMW correction of a backsolve ``x0`` (one column or ``k``;
        with a lane axis under a batched payload)."""
        if factor.smw is None:
            return x0
        E, T, S_lu = factor.smw
        n = E.shape[-2]
        squeeze = x0.ndim == E.ndim - 1
        xm = x0[..., None] if squeeze else x0
        z = torch.linalg.lu_solve(*S_lu, E.transpose(-1, -2) @ xm[..., :n, :])
        xm = xm - T @ z
        return xm[..., 0] if squeeze else xm

    def _attach_smw(self, factor, lr, active=None, prev=None):
        """The SMW payload of the low-rank part ``ΔW = V Vᵀ − U Uᵀ =
        E C Eᵀ`` at factorization time: one backsolve of 2p right-hand
        sides (on the banded path, one launch of the cluster solve with
        k = 2p) and the LU factorization of the small matrix S.  For a
        batch, the lanes in ``active`` (numpy bool (B,)) get theirs (one
        launch of K4 with k = 2p over them, then one (2p, 2p) LU per
        lane); the others keep ``prev``'s payload, or the zero one."""
        n, p_mem = lr.U.shape[-2:]
        E = torch.cat([lr.U, lr.V], -1)                  # (…, n, 2p)
        Epad = E.new_zeros(E.shape[:-2] + (self.sys_size(), 2 * p_mem))
        Epad[..., :n, :] = E
        T = self._backsolve(factor, Epad, active)        # K₀⁻¹ Ẽ
        C = torch.diag(torch.cat([-E.new_ones(p_mem), E.new_ones(p_mem)]))
        S = C + E.transpose(-1, -2) @ T[..., :n, :]
        if active is None:
            return factor._replace(smw=(E, T,
                                        tuple(torch.linalg.lu_factor(S))))
        on = torch.as_tensor(np.asarray(active, dtype=bool),
                             device=self.device)
        S = torch.where(on[:, None, None], S, C)         # lanes not factored
        new = (E, T, tuple(torch.linalg.lu_factor(S)))
        old = (prev.smw if prev is not None and prev.smw is not None
               else self._zero_smw(n, p_mem, lanes=len(active)))
        return factor._replace(smw=lane_where(on, new, old))

    def _zero_smw(self, n: int, p_mem: int, lanes: int = None):
        """The zero SMW payload (no correction): the template of the
        persisted context; with ``lanes``, one per lane."""
        lead = () if lanes is None else (lanes,)
        z = torch.zeros(lead + (n, 2 * p_mem), dtype=torch.float64,
                        device=self.device)
        eye = torch.eye(2 * p_mem, dtype=torch.float64, device=self.device)
        piv = torch.arange(1, 2 * p_mem + 1, dtype=torch.int32,
                           device=self.device)
        return (z, z.new_zeros(lead + (self.sys_size(), 2 * p_mem)),
                (eye.expand(lead + eye.shape).clone(),
                 piv.expand(lead + piv.shape).clone()))

    def zero_context(self) -> KKTContext:
        """An all-zero context with the factor's shapes: the persisted
        context of a solve that has factored nothing yet (no least-squares
        start), as the JAX package's template."""
        N = self.sys_size()
        factor = EquilibratedFactor(
            inner=ds.zero_factor(
                self.solver, N, self.fact_dtype,
                block=self.opts.ldl_block_size or 64,
                solve_mode=self.solve_mode, device=self.device,
                split=self._split(), hykkt_backend=self._hykkt_backend(),
                cg_tol=self.opts.hykkt_cg_tol,
                cg_maxiter=self.opts.hykkt_cg_maxiter),
            d=torch.ones(N, dtype=torch.float64, device=self.device))
        return self._zero_ctx(factor)

    def _zero_ctx(self, factor) -> KKTContext:
        p = self.prob
        hess = p.hess_template()
        if not torch.is_tensor(hess):
            factor = factor._replace(smw=self._zero_smw(
                p.n, self.opts.quasi_newton_options.max_history))
        ones, zeros = p.zeros(p.nw) + 1.0, p.zeros(p.nw)
        return KKTContext(
            hess=hess, jac=p.jac_template(), pr_diag=ones,
            du_diag=p.zeros(p.m), reg=ones, dl=ones, du_=ones, zl=zeros,
            zu=zeros, factor=factor)

    def sys_size(self) -> int:
        """Dimension of the assembled matrix."""
        return self.prob.nw + self.prob.m

    # -- diagonals (set_aug_diagonal!, kernels.jl:4-27) --------------------

    def aug_diagonals(self, reg, du_diag, dl, du_, zl, zu):
        pr_diag = (
            reg
            + torch.where(self.lb, zl / dl, 0.0)
            + torch.where(self.ub, zu / du_, 0.0)
        )
        return pr_diag, du_diag

    # -- inertia -----------------------------------------------------------

    def is_inertia_correct(self, pos, zero, neg) -> bool:
        """num_pos == num_variables && num_zero == 0 (KKTsystem.jl:242-244)."""
        return zero == 0 and pos == self.prob.nw

    def has_inertia(self) -> bool:
        return ds.has_inertia(self.solver)

    def inertia(self, ctx: KKTContext):
        return ds.inertia(ctx.factor.inner)

    # -- solve -------------------------------------------------------------

    def reduce_rhs(self, ctx: KKTContext, w: KKTVec) -> KKTVec:
        """Fold bound-dual rows into the primal RHS (kernels.jl:182-195)."""
        xp = (
            w.xp
            + torch.where(self.lb, w.zl / ctx.dl, 0.0)
            + torch.where(self.ub, w.zu / ctx.du_, 0.0)
        )
        return w._replace(xp=xp)

    def finish_aug_solve(self, ctx: KKTContext, w: KKTVec, pzl, pzu) -> KKTVec:
        """Recover Δν, Δw from the reduced solution (kernels.jl:198-204)."""
        dzl = torch.where(self.lb, (pzl - ctx.zl * w.xp) / ctx.dl, 0.0)
        dzu = torch.where(self.ub, (ctx.zu * w.xp - pzu) / ctx.du_, 0.0)
        return w._replace(zl=dzl, zu=dzu)

    def solve(self, ctx: KKTContext, b: KKTVec, active=None) -> KKTVec:
        """solve_kkt! for the reduced system (factorization.jl:41-46);
        for a batch, the backsolve runs for the ``active`` lanes."""
        nw = self.prob.nw
        w = self.reduce_rhs(ctx, b)
        if self.prob.m > 0:
            sol = self._backsolve(ctx.factor, torch.cat([w.xp, w.y], -1),
                                  active)
            w = w._replace(xp=sol[..., :nw], y=sol[..., nw:])
        else:
            w = w._replace(xp=self._backsolve(ctx.factor, w.xp, active))
        return self.finish_aug_solve(ctx, w, b.zl, b.zu)

    def solve_refine(self, ctx: KKTContext, b: KKTVec, mu=None, active=None):
        """Refined solve; ``mu`` (optional) enables the μ-aware stopping
        target (RichardsonOptions.mu_scaled): the effective tol is
        ``max(tol, min(mu_tol_cap, mu_tol_factor·μ))``.  With ``active``
        the solve is batched: ``mu`` is a ``(B,)`` array and the result
        ``(x, converged (B,), iters (B,))``."""
        tol = self.opts.richardson_tol
        ro = self.opts.richardson
        if self.opts.iterator != "richardson":
            # GMRES keeps the static tolerance, as in the JAX package
            if active is not None:
                return solve_gmres_batched(
                    lambda w, run: self.solve(ctx, w, run),
                    lambda x: self.mul(ctx, x),
                    b, active,
                    max_iter=ro.max_iter,
                    tol=tol,
                    acceptable_tol=self.opts.richardson_acceptable_tol,
                )
            return solve_gmres(
                lambda w: self.solve(ctx, w),
                lambda x: self.mul(ctx, x),
                b,
                max_iter=ro.max_iter,
                tol=tol,
                acceptable_tol=self.opts.richardson_acceptable_tol,
            )
        if active is not None:
            if mu is not None and ro.mu_scaled:
                tol = np.maximum(tol, np.minimum(
                    ro.mu_tol_cap, ro.mu_tol_factor * np.asarray(mu)))
            return solve_refine_batched(
                lambda w, run: self.solve(ctx, w, run),
                lambda x: self.mul(ctx, x),
                b, active,
                max_iter=ro.max_iter,
                tol=tol,
                acceptable_tol=self.opts.richardson_acceptable_tol,
            )
        if mu is not None and ro.mu_scaled:
            tol = max(tol, min(ro.mu_tol_cap, ro.mu_tol_factor * mu))
        return solve_refine(
            lambda w: self.solve(ctx, w),
            lambda x: self.mul(ctx, x),
            b,
            max_iter=ro.max_iter,
            tol=tol,
            acceptable_tol=self.opts.richardson_acceptable_tol,
        )

    # -- assembly + factorization -----------------------------------------

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False, active=None, prev=None):
        if active is not None:
            raise _later("batched dense KKT storage")
        p = self.prob
        pr_diag, du_diag = self.aug_diagonals(reg, du_diag, dl, du_, zl, zu)
        n, nw, m = p.n, p.nw, p.m
        W = hess.new_zeros((nw, nw))
        W[:n, :n] = hess
        W.diagonal().add_(pr_diag)
        if m > 0:
            K = torch.cat([torch.cat([W, jac.T], 1),
                           torch.cat([jac, torch.diag(du_diag)], 1)])
        else:
            K = W
        return KKTContext(
            hess=hess, jac=jac, pr_diag=pr_diag, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu,
            factor=self._factorize_matrix(
                K, self._k25_scaling(dl, du_, m)
                if self.opts.kkt_scaling == "k25" else None,
                split=self._split(), rr=rr),
        )

    # -- operator application (for iterative refinement) -------------------

    def mul(self, ctx: KKTContext, v: KKTVec) -> KKTVec:
        """w = K v with the *unreduced* operator (factorization.jl:303-324 +
        _kktmul!, kernels.jl:161-180), in positive-slack convention."""
        p = self.prob
        lb, ub = self.lb, self.ub
        hv = ctx.hess @ v.xp[: p.n]
        wx = torch.cat([hv, hv.new_zeros(p.nw - p.n)])
        wx = wx + ctx.reg * v.xp
        if p.m > 0:
            wx = wx + ctx.jac.T @ v.y
            wy = ctx.jac @ v.xp + ctx.du_diag * v.y
        else:
            wy = v.y
        wx = wx - torch.where(lb, v.zl, 0.0) + torch.where(ub, v.zu, 0.0)
        wzl = torch.where(lb, ctx.zl * v.xp + ctx.dl * v.zl, 0.0)
        wzu = torch.where(ub, ctx.zu * v.xp - ctx.du_ * v.zu, 0.0)
        return KKTVec(xp=wx, y=wy, zl=wzl, zu=wzu)

    def mul_hess_blk(self, ctx: KKTContext, t):
        """wx = (W + Σ) t for the inertia-free curvature test
        (factorization.jl:326-331)."""
        p = self.prob
        ht = ctx.hess @ t[: p.n]
        return torch.cat([ht, ht.new_zeros(p.nw - p.n)]) + t * ctx.pr_diag

    def jtprod(self, jac, y):
        """jacl = Aᵀ y over the full primal space."""
        if self.prob.m == 0:
            return jac.new_zeros(self.prob.nw)
        return jac.T @ y
