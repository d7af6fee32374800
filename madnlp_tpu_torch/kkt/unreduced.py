"""Unreduced KKT system, the bound duals kept inside the matrix — port of
``madnlp_tpu/kkt/unreduced.py`` (``DenseUnreducedKKT``,
``SparseUnreducedKKT``; the reference's ``SparseUnreducedKKTSystem``,
src/KKT/Sparse/unreduced.jl, solve path src/IPM/factorization.jl:29-39).

The 6×6 block system of src/KKT/KKTsystem.jl:10-34 symmetrized with the
√z scaling:

    [ W + δwI   Aᵀ     Slᵀ          Suᵀ        ]   Sl = diag(√zl) (masked)
    [ A         -δcI   0            0          ]   Su = diag(√zu)
    [ Sl        0      diag(xl−x)   0          ]
    [ Su        0      0            diag(x−xu) ]

of size 3·nw + m in the masked full-length layout: an unmasked bound row
carries a decoupled −1 diagonal, matching the negative corner blocks, so
the inertia test stays ``num_pos == nw``.  The right-hand side's bound rows
are scaled by 1/√z before the solve and the result by ∓√z after it.  The
refinement operator is the unreduced operator of the reduced systems
(``DenseKKT.mul``, ``SparseKKT``'s sparse products), and ``pr_diag`` holds
only the regularization.

On the banded path (``linear_solver=BANDED``, K1/K2 on the card) each
bound-dual row is a one-entry "constraint" row, interleaved right after its
variable by ``kkt_interleaved_ordering``; its diagonal ``xl − x < 0`` is
whole on arrival.  The band is not the augmented system, so it is not the
refinement operator.  The dense assembly is a gather-sum over a host-built
contributor table (:mod:`..ops.segment`), deterministic on every device.
A compact L-BFGS Hessian is refused, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.banded import kkt_interleaved_ordering
from ..utils.options import HessianApproximation
from .dense import DenseKKT, KKTContext
from .sparse import SparseKKT
from .vec import KKTVec


def _bound_parts(kkt, dl, du_, zl, zu):
    """√zl, √zu on the bounded rows (0 elsewhere) and the corner diagonals
    xl − x, x − xu (−1 on the rows without that bound)."""
    sl = torch.where(kkt.lb, torch.sqrt(zl), 0.0)
    su = torch.where(kkt.ub, torch.sqrt(zu), 0.0)
    ldg = torch.where(kkt.lb, -dl, -1.0)
    udg = torch.where(kkt.ub, -du_, -1.0)
    return sl, su, ldg, udg


def _unreduced_solve(kkt, ctx: KKTContext, b: KKTVec) -> KKTVec:
    """solve_kkt! for the unreduced system (factorization.jl:29-39):
    pre-scale the bound-dual rows by 1/√z, solve, post-scale by ∓√z."""
    p = kkt.prob
    lb, ub = kkt.lb, kkt.ub
    sl = torch.where(lb, torch.sqrt(ctx.zl), 0.0)
    su = torch.where(ub, torch.sqrt(ctx.zu), 0.0)
    wzl = torch.where(lb & (sl != 0.0),
                      b.zl / torch.where(sl != 0.0, sl, 1.0), b.zl)
    wzu = torch.where(ub & (su != 0.0),
                      b.zu / torch.where(su != 0.0, su, 1.0), b.zu)
    sol = kkt._backsolve(ctx.factor, torch.cat([b.xp, b.y, wzl, wzu]))
    nw, m = p.nw, p.m
    tl, tu = sol[nw + m: 2 * nw + m], sol[2 * nw + m:]
    return KKTVec(xp=sol[:nw], y=sol[nw: nw + m],
                  zl=torch.where(lb, -sl * tl, 0.0),
                  zu=torch.where(ub, su * tu, 0.0))


def _sigma(kkt, ctx):
    return (torch.where(kkt.lb, ctx.zl / ctx.dl, 0.0)
            + torch.where(kkt.ub, ctx.zu / ctx.du_, 0.0))


class DenseUnreducedKKT(DenseKKT):
    """The unreduced system of a dense-callback model, dense storage."""

    def sys_size(self) -> int:
        p = self.prob
        return 3 * p.nw + p.m

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False):
        p = self.prob
        n, nw, m = p.n, p.nw, p.m
        W = hess.new_zeros((nw, nw))
        W[:n, :n] = hess
        W.diagonal().add_(reg)        # pr_diag = reg only (kernels.jl:29-34)
        sl, su, ldg, udg = _bound_parts(self, dl, du_, zl, zu)
        Zmw, Zww = W.new_zeros((m, nw)), W.new_zeros((nw, nw))
        Sl, Su = torch.diag(sl), torch.diag(su)
        K = torch.cat([
            torch.cat([W, jac.T, Sl, Su], 1),
            torch.cat([jac, torch.diag(du_diag), Zmw, Zmw], 1),
            torch.cat([Sl, Zmw.T, torch.diag(ldg), Zww], 1),
            torch.cat([Su, Zmw.T, Zww, torch.diag(udg)], 1)])
        return KKTContext(
            hess=hess, jac=jac, pr_diag=reg, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu, factor=self._factorize_matrix(K))

    def solve(self, ctx: KKTContext, b: KKTVec) -> KKTVec:
        return _unreduced_solve(self, ctx, b)

    def mul_hess_blk(self, ctx: KKTContext, t):
        """factorization.jl:340-350: the Σ terms added explicitly (pr_diag
        of the unreduced system holds only the regularization)."""
        p = self.prob
        ht = ctx.hess @ t[: p.n]
        wx = torch.cat([ht, ht.new_zeros(p.nw - p.n)])
        return wx + t * (ctx.pr_diag + _sigma(self, ctx))


class SparseUnreducedKKT(SparseKKT):
    """The unreduced system assembled from COO values: banded (K1/K2) or
    dense storage."""

    _band_is_augmented = False   # the band holds the 4-block system

    def __init__(self, prob, opts):
        if opts.hessian_approximation == HessianApproximation.COMPACT_LBFGS:
            raise ValueError(
                "quasi-Newton low-rank Hessians are not supported by the "
                "unreduced system; use KKTSystem.SPARSE")
        super().__init__(prob, opts)

    def sys_size(self) -> int:
        p = self.prob
        return 3 * p.nw + p.m

    def _extended_jac_pattern(self):
        """The Jacobian pattern with the 2·nw bound-dual rows appended as
        one-entry rows (row m+i: lower bound of w_i, m+nw+i: upper)."""
        p = self.prob
        iw = np.arange(p.nw, dtype=np.int64)
        rows = np.concatenate([np.asarray(p.jac_rows_aug), p.m + iw,
                               p.m + p.nw + iw])
        cols = np.concatenate([np.asarray(p.jac_cols_aug), iw, iw])
        return rows, cols

    def _band_pattern(self):
        """Lower COO in the order of ``[reg, du_diag, ldg, udg, jac, sl,
        su, hess]``."""
        p = self.prob
        N = self.sys_size()
        diag = np.arange(N, dtype=np.int64)
        hr, hc = self._hess_pattern()
        jr, jc = self._extended_jac_pattern()
        return (np.concatenate([diag, p.nw + jr, hr]),
                np.concatenate([diag, jc, hc]), N)

    def _band_ordering(self):
        p = self.prob
        hr, hc = self._hess_pattern()
        jr, jc = self._extended_jac_pattern()
        return kkt_interleaved_ordering(hr, hc, jr, jc, p.nw, p.m + 2 * p.nw)

    def _dense_pattern(self):
        """Both triangles in the order of ``[reg, du_diag, ldg, udg, jac,
        jac, hess, hess_off, sl, sl, su, su]``."""
        p = self.prob
        N = self.sys_size()
        nw, m = p.nw, p.m
        diag = np.arange(N, dtype=np.int64)
        iw = np.arange(nw, dtype=np.int64)
        jr = nw + np.asarray(p.jac_rows_aug)
        jc = np.asarray(p.jac_cols_aug)
        hr, hc = self._hess_pattern()
        off = self._h_off_np
        ldx, udx = nw + m + iw, 2 * nw + m + iw
        rows = np.concatenate([diag, jr, jc, hr, hc[off], ldx, iw, udx, iw])
        cols = np.concatenate([diag, jc, jr, hc, hr[off], iw, ldx, iw, udx])
        return rows, cols, N

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False):
        sl, su, ldg, udg = _bound_parts(self, dl, du_, zl, zu)
        if self.banded:
            factor = self._banded_factorize_coo(
                torch.cat([reg, du_diag, ldg, udg, jac, sl, su, hess]))
        else:
            factor = self._factorize_matrix(self._assemble_dense_values(
                torch.cat([reg, du_diag, ldg, udg, jac, jac, hess,
                           hess[self._h_off], sl, sl, su, su])))
        return KKTContext(
            hess=hess, jac=jac, pr_diag=reg, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu, factor=factor)

    def solve(self, ctx: KKTContext, b: KKTVec) -> KKTVec:
        return _unreduced_solve(self, ctx, b)

    def mul_hess_blk(self, ctx: KKTContext, t):
        p = self.prob
        ht = self.hess_mul(ctx.hess, t[: p.n])
        wx = torch.cat([ht, ht.new_zeros(p.nw - p.n)])
        return wx + t * (ctx.pr_diag + _sigma(self, ctx))
