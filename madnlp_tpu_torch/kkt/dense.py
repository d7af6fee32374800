"""Reduced augmented KKT system, the base of :class:`..sparse.SparseKKT` —
port of the factorization-independent part of ``madnlp_tpu/kkt/dense.py``.

The system is the reduced augmented form (KKTsystem.jl:38-58)

    [ W + Σx + δwI      0          Aₑᵀ  Aᵢᵀ ] [Δx]
    [ 0                Σs + δwI     0   -I  ] [Δs]
    [ Aₑ                0          -δcI  0  ] [Δy]
    [ Aᵢ               -I           0  -δcI ] [Δz]

with the bound duals eliminated and recovered analytically
(kernels.jl:182-204), positive-slack convention ``dl = x - xl``,
``du = xu - x``.  Dense storage and dense factorizations come in a later
slice of the port; this class carries the diagonals, the reduction and
recovery of the bound-dual rows, the refined solve with μ-aware stopping,
and leaves assembly, factorization, backsolve and operator to subclasses.

Every function also takes a batch: vectors and context with a leading
lane axis ``(B, ·)``, an ``active`` lane mask (numpy bool ``(B,)``) that
selects the lanes a backsolve or refinement runs for, and a per-lane μ.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.refine import solve_refine, solve_refine_batched
from ..utils.options import LinearSolver, MadNLPOptions
from .vec import KKTVec

_FACT_DTYPES = {"float64": torch.float64, "float32": torch.float32}


class EquilibratedFactor(NamedTuple):
    """Factor of D·K·D plus the Ruiz scaling vector d (original ordering)."""

    inner: object
    d: torch.Tensor
    opband: object = None   # unscaled f64 operator band (banded path): the
    # iterative-refinement operator as block-banded mat-vecs


class KKTContext(NamedTuple):
    """Per-iteration numeric payload of the KKT system."""

    hess: torch.Tensor      # (nnzh,) Hessian values
    jac: torch.Tensor       # (nnzj + ns,) augmented Jacobian values
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
        # the only factorization of this slice, the banded LDLᵀ, has one
        return self.solver == LinearSolver.BANDED

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
        if self.opts.iterator != "richardson":
            raise NotImplementedError(
                f"iterator={self.opts.iterator!r} comes in a later slice "
                "of the port")
        tol = self.opts.richardson_tol
        ro = self.opts.richardson
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

    # -- provided by the storage-specific subclass ------------------------

    def _backsolve(self, factor, rhs, active=None):
        raise NotImplementedError(
            "dense KKT storage comes in a later slice of the port")

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False, active=None, prev=None):
        raise NotImplementedError(
            "dense KKT storage comes in a later slice of the port")

    def inertia(self, ctx: KKTContext):
        raise NotImplementedError(
            "dense KKT storage comes in a later slice of the port")

    def mul(self, ctx: KKTContext, v: KKTVec) -> KKTVec:
        raise NotImplementedError(
            "dense KKT storage comes in a later slice of the port")
