"""Condensed-space KKT system with dense storage — port of
``madnlp_tpu/kkt/condensed_dense.py:DenseCondensedKKT`` (the reference's
``DenseCondensedKKTSystem``, src/KKT/Dense/condensed.jl, and the solve
path src/IPM/factorization.jl:190-229).

Eliminates both the bound duals *and* the slack/inequality rows:

    K_cond = [ W + Σx + Jᵢᵀ D Jᵢ    Aₑᵀ    ]        D = Σs / (1 − Σd Σs)
             [ Aₑ                  Σd(eq) ]

of size n + n_eq.  Without equality rows K_cond is symmetric positive
definite after regularization, so Cholesky applies and its success is the
inertia test (BLOCK_CHOLESKY and HYKKT become Cholesky there); with them
the solver's preset is LDLᵀ, and the range-space solvers split the matrix
at n.  A dense-callback model takes this class for ``SPARSE_CONDENSED``
too.

Inertia rule: ``num_zero == 0 && num_neg == n_eq`` (condensed.jl:189-191).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.options import LinearSolver
from .dense import DenseKKT, KKTContext, _later
from .vec import KKTVec


class DenseCondensedKKT(DenseKKT):
    def __init__(self, prob, opts):
        super().__init__(prob, opts)
        self.eq_sel = np.nonzero(~prob.ineq_mask)[0].astype(np.int64)
        self.n_eq = len(self.eq_sel)
        if opts.linear_solver in (LinearSolver.BLOCK_CHOLESKY,
                                  LinearSolver.HYKKT):
            # with no equalities the condensed matrix is plain SPD
            self.solver = (opts.linear_solver if self.n_eq
                           else LinearSolver.CHOLESKY)
        self._eq = torch.as_tensor(self.eq_sel, device=self.device)
        self._sel = torch.as_tensor(prob.slack_sel, device=self.device)

    def _split(self):
        """The condensed matrix ``[W̃ Aₑᵀ; Aₑ Σd]`` splits at n."""
        if self.solver in (LinearSolver.BLOCK_CHOLESKY, LinearSolver.HYKKT):
            return self.prob.n
        return None

    # -- assembly + factorization -----------------------------------------

    def _diag_buffer(self, pr_diag, du_diag):
        """D = Σs / (1 − Σd Σs) over inequality rows (condensed.jl:160-162)."""
        sigma_s = pr_diag[self.prob.n:]
        sigma_d = du_diag[self._sel]
        return sigma_s / (1.0 - sigma_d * sigma_s)

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False, active=None, prev=None):
        if active is not None:
            raise _later("batched dense KKT storage")
        p = self.prob
        pr_diag, du_diag = self.aug_diagonals(reg, du_diag, dl, du_, zl, zu)
        n = p.n
        Jx = jac[:, :n]
        W = hess + torch.diag(pr_diag[:n])
        if p.ns:
            # JᵢᵀDJᵢ as one GEMM of the √D-scaled rows (condensed.jl:146-172)
            Js = Jx[self._sel] * torch.sqrt(self._diag_buffer(pr_diag,
                                                              du_diag))[:, None]
            W = W + Js.T @ Js
        if self.n_eq:
            Ae = Jx[self._eq]
            Kc = torch.cat([torch.cat([W, Ae.T], 1),
                            torch.cat([Ae, torch.diag(du_diag[self._eq])], 1)])
        else:
            Kc = W
        return KKTContext(
            hess=hess, jac=jac, pr_diag=pr_diag, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu,
            factor=self._factorize_matrix(Kc, split=self._split(), rr=rr),
        )

    def sys_size(self) -> int:
        return self.prob.n + self.n_eq

    # -- inertia -----------------------------------------------------------

    def is_inertia_correct(self, pos, zero, neg) -> bool:
        return zero == 0 and neg == self.n_eq

    # -- solve (factorization.jl:190-229) ----------------------------------

    def solve(self, ctx: KKTContext, b: KKTVec, active=None) -> KKTVec:
        if active is not None:
            raise _later("batched dense KKT storage")
        p = self.prob
        n = p.n
        w = self.reduce_rhs(ctx, b)
        wx, ws = w.xp[:n], w.xp[n:]
        D = self._diag_buffer(ctx.pr_diag, ctx.du_diag)
        sigma_s = ctx.pr_diag[n:]
        Jx = ctx.jac[:, :n]

        buffer = wx.new_zeros(p.m)
        if p.ns:
            buffer[self._sel] = D * (w.y[self._sel] + ws / sigma_s)
            xx = wx + Jx.T @ buffer
        else:
            xx = wx

        if self.n_eq:
            sol = self._backsolve(ctx.factor, torch.cat([xx, w.y[self._eq]]))
            dx, xy = sol[:n], sol[n:]
        else:
            dx = self._backsolve(ctx.factor, xx)

        dual = Jx @ dx
        if self.n_eq:
            dual[self._eq] = xy
        if p.ns:
            dual[self._sel] = dual[self._sel] * D
        dual = dual - buffer
        ds_out = (ws + dual[self._sel]) / sigma_s
        w = w._replace(xp=torch.cat([dx, ds_out]), y=dual)
        return self.finish_aug_solve(ctx, w, b.zl, b.zu)
