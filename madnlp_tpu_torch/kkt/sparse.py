"""Sparse-callback KKT systems — port of ``madnlp_tpu/kkt/sparse.py``:
:class:`SparseKKT`, the reduced augmented system (the banded sparse direct
path and the dense-storage branch that every other linear solver takes),
and :class:`SparseCondensedKKT`, the Lifted-KKT condensed system.

Banded (``linear_solver=BANDED``).  Per factorization: one deterministic
assembly of the raw f64 band from the COO values ``[pr_diag, du_diag, jac,
hess]``, Ruiz equilibration on the band, the congruence-scaled band cast to
``opts.dtype`` and factored (block-banded LDLᵀ: the K1 kernel on the card,
its plain version on the CPU).  Backsolves run K2 on the scaled, permuted
right-hand side; the f64 refinement operator is the unscaled symmetrized
band (block-banded mat-vecs, no scatters).

Under compact L-BFGS (``hessian_approximation=COMPACT_LBFGS``) the
Hessian is a :class:`..ipm.quasi_newton.LowRankHessian`: its diagonal is
the assembled Hessian pattern (``_hess_pattern``), and every solve applies
the low-rank part by SMW (:meth:`.dense.DenseKKT._attach_smw`, whose
2p-column backsolve is one launch of K2 with k = 2p).  ``kkt_scaling="k25"``
takes the analytic √Ξ scaling in place of Ruiz on either storage.

Dense storage (``LDL``, ``CHOLESKY``, ``LU``, ``QR``, ``EVD``,
``BLOCK_CHOLESKY``, ``HYKKT``): the same COO values are assembled into one
dense (nw+m, nw+m) matrix and factored by :class:`.dense.DenseKKT`'s path
(JAX ``kkt/sparse.py:594-610``, with the primal/dual split and the
robust-restoration flag for the range-space solvers); this is where the
sparse preset's LDL fallback for small systems lands.  The refinement
operator is the sparse products.

Every COO assembly and product is a gather-sum over host-built
contributor tables (:mod:`..ops.segment`), deterministic on every device;
the JAX package's scatter-adds would sum duplicates by atomics on CUDA.

A batch of same-structure systems (``solve_batch``) runs the banded path
with a leading lane axis: assembly, Ruiz and inertia per lane, the factor
through K3 and the backsolves through K4, both under an ``active`` lane
mask.  A lane left out of a factorization keeps its previous factor, so
the masked δ-regularization ladder never overwrites a factor still in use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ipm.quasi_newton import LowRankHessian
from ..ops import banded_kernels
from ..ops.banded import (
    BandStructure,
    banded_inertia,
    jtdj_pair_map,
    banded_symmetrize,
    banded_symv,
    kkt_interleaved_ordering,
    ruiz_band,
    scale_band,
)
from ..ops.segment import segment_map, segment_sum
from ..utils.options import HessianApproximation, LinearSolver
from .dense import DenseKKT, EquilibratedFactor, KKTContext
from .vec import KKTVec


def _later(what: str):
    return NotImplementedError(f"{what} comes in a later slice of the port")


def _lowrank_corr(lr: LowRankHessian, v):
    """``(V Vᵀ − U Uᵀ) v`` of a compact L-BFGS operator (one vector, or a
    lane axis on both)."""
    if v.ndim == 1:
        return -lr.U @ (lr.U.T @ v) + lr.V @ (lr.V.T @ v)
    v = v[..., None]
    Ut, Vt = lr.U.transpose(-1, -2), lr.V.transpose(-1, -2)
    return (-lr.U @ (Ut @ v) + lr.V @ (Vt @ v))[..., 0]


class SparseKKT(DenseKKT):
    """Reduced augmented KKT with banded assembly from sparse callbacks."""

    # the assembled band is the augmented system [W+Σ Jᵀ; J D]: its f64 copy
    # is the refinement operator (banded_symv); a system whose band holds
    # another matrix (condensed, unreduced) refines with the sparse products
    _band_is_augmented = True

    def __init__(self, prob, opts):
        super().__init__(prob, opts)
        if opts.linear_solver in (LinearSolver.BLOCK_ARROW,
                                  LinearSolver.MULTIFRONTAL):
            raise _later(f"linear_solver={opts.linear_solver}")
        # compact L-BFGS: the Hessian block is σI (+ SMW low-rank at solve
        # time), so the assembled pattern is just the diagonal
        self.lowrank = (opts.hessian_approximation
                        == HessianApproximation.COMPACT_LBFGS)
        self.banded = opts.linear_solver == LinearSolver.BANDED
        if opts.banded_partitions:
            raise _later("banded_partitions (SPIKE)")
        if opts.banded_backend != "auto":
            raise ValueError(
                "the port accepts only banded_backend='auto': the device of "
                "the tensors decides the backend")
        p = prob
        dev = self.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        jr, jc = p.jac_rows_aug, p.jac_cols_aug
        hr, hc = self._hess_pattern()
        self.jr, self.jc = t(jr), t(jc)
        self.hr, self.hc = t(hr), t(hc)
        self.h_offdiag = t(hr != hc)
        # contributor tables: Aᵀy by column, J·v by row, H·v by row and col
        self._jt_table = t(segment_map(jc, p.nw))
        self._jp_table = t(segment_map(jr, p.m))
        self._hr_table = t(segment_map(hr, p.n))
        self._hc_table = t(segment_map(hc, p.n))
        if self.banded:
            self._init_band_structure()
        else:
            self._init_dense_assembly()

    def _hess_pattern(self):
        """The assembled Hessian's (rows, cols): the model's lower COO, or
        the diagonal under compact L-BFGS."""
        p = self.prob
        if self.lowrank:
            diag = np.arange(p.n, dtype=np.int64)
            return diag, diag
        return np.asarray(p.hess_rows), np.asarray(p.hess_cols)

    # -- dense storage -------------------------------------------------------

    def _dense_pattern(self):
        """(rows, cols, N) of the dense matrix, both triangles, in the order
        of the value vector ``[pr_diag, du_diag, jac, jac, hess,
        hess_off]``: the Jacobian block and its mirror, the Hessian's lower
        entries and the mirrors of its off-diagonal ones."""
        p = self.prob
        N = p.nw + p.m
        diag = np.arange(N, dtype=np.int64)
        jr = p.nw + np.asarray(p.jac_rows_aug)
        jc = np.asarray(p.jac_cols_aug)
        hr, hc = self._hess_pattern()
        off = self._h_off_np
        rows = np.concatenate([diag, jr, jc, hr, hc[off]])
        cols = np.concatenate([diag, jc, jr, hc, hr[off]])
        return rows, cols, N

    def _init_dense_assembly(self):
        """Gather map of the dense (N, N) matrix from its value vector
        (:meth:`_dense_pattern`): the distinct positions and, for each, a
        padded row of its contributors."""
        hr, hc = self._hess_pattern()
        self._h_off_np = np.flatnonzero(hr != hc)
        self._h_off = torch.as_tensor(self._h_off_np, device=self.device)
        rows, cols, N = self._dense_pattern()
        flat, inv = np.unique(rows * N + cols, return_inverse=True)
        self._dense_n = N
        self._dense_flat = torch.as_tensor(flat, device=self.device)
        self._dense_table = torch.as_tensor(
            segment_map(inv.ravel(), len(flat)), device=self.device)

    def _assemble_dense_values(self, vals):
        """The dense (N, N) matrix of the value vector of
        :meth:`_dense_pattern`, duplicates summed in a fixed order."""
        N = self._dense_n
        K = vals.new_zeros(N * N)
        K[self._dense_flat] = segment_sum(vals, self._dense_table)
        return K.reshape(N, N)

    def _assemble_dense(self, pr_diag, du_diag, jac, hess):
        return self._assemble_dense_values(
            torch.cat([pr_diag, du_diag, jac, jac, hess, hess[self._h_off]]))

    # -- block-banded backend ----------------------------------------------

    def _band_pattern(self):
        """Lower-COO pattern of the assembled matrix in ORIGINAL ordering,
        in the order of the value vector ``[pr_diag, du_diag, jac, hess]``."""
        p = self.prob
        N = p.nw + p.m
        diag = np.arange(N, dtype=np.int64)
        hr, hc = self._hess_pattern()
        rows = np.concatenate([diag, p.nw + np.asarray(p.jac_rows_aug), hr])
        cols = np.concatenate([diag, np.asarray(p.jac_cols_aug), hc])
        return rows, cols, N

    def _band_ordering(self):
        p = self.prob
        hr, hc = self._hess_pattern()
        return kkt_interleaved_ordering(
            hr, hc, p.jac_rows_aug, p.jac_cols_aug, p.nw, p.m,
        )

    def _init_band_structure(self):
        rows, cols, N = self._band_pattern()
        block = self.opts.resolved_banded_block(N)
        self.bstruct = BandStructure(rows, cols, N, block=block,
                                     perm=self._band_ordering())
        self._assemble = self.bstruct.assembly(self.bstruct.map(rows, cols),
                                               self.device)
        self._bperm = torch.as_tensor(self.bstruct.perm, device=self.device)
        self._biperm = torch.as_tensor(self.bstruct.iperm, device=self.device)

    def _banded_factorize_coo(self, vals, active=None, prev=None,
                              d_analytic=None):
        """One assembly of the raw f64 band; Ruiz, the congruence scaling
        and the refinement operator reuse it (``d_analytic``: the K2.5
        scaling, taken under ``kkt_scaling="k25"``).  For a batch (``vals
        (B, nnz)``), the lanes that ``active`` leaves out keep ``prev``'s
        factor (K3 does not touch them)."""
        bs = self.bstruct
        lead = vals.shape[:-1]
        raw = self._assemble(vals)
        raw_sym = banded_symmetrize(bs, raw)
        mode = self.opts.kkt_scaling
        if mode == "k25" and d_analytic is not None:
            d = d_analytic
            d_perm = torch.cat([d[..., self._bperm],
                                d.new_ones(lead + (bs.nbp * bs.b - bs.N,))],
                               -1).reshape(lead + (bs.nbp, bs.b))
        elif mode == "ruiz":
            d_perm = ruiz_band(bs, raw_sym)
            d = d_perm.reshape(lead + (-1,))[..., self._biperm]
        else:
            d = vals.new_ones(lead + (bs.N,))
            d_perm = vals.new_ones(lead + (bs.nbp, bs.b))
        band = scale_band(bs, raw, d_perm).to(self.fact_dtype)
        if not self._band_is_augmented:
            raw_sym = None
        if active is None:
            inner = banded_kernels.factorize(bs, band)
            return EquilibratedFactor(inner=inner, d=d, opband=raw_sym)
        if prev is None:
            invL = band.new_zeros((lead[0], bs.nbp, bs.b, bs.b))
            dpiv = band.new_ones((lead[0], bs.nb * bs.b))
        else:
            on = torch.as_tensor(active, device=self.device)
            on5 = on[:, None, None, None, None]
            band = torch.where(on5, band, prev.inner.band)
            raw_sym = torch.where(on5, raw_sym, prev.opband)
            d = torch.where(on[:, None], d, prev.d)
            # K3 rewrites the active lanes' invL and pivots in full and
            # leaves the others as they are
            invL, dpiv = prev.inner.invL, prev.inner.d
        inner = banded_kernels.factorize_batched(bs, band, invL, dpiv, active)
        return EquilibratedFactor(inner=inner, d=d, opband=raw_sym)

    def _backsolve(self, factor, rhs, active=None):
        if not self.banded:
            return super()._backsolve(factor, rhs, active)
        # K x = b  ⟺  (DKD)(D⁻¹x) = D b; rhs (N,) or (N, k), with a lane
        # axis for a batch
        d = factor.d[..., None] if rhs.ndim > factor.d.ndim else factor.d
        scaled = (d * rhs).to(self.fact_dtype)
        if active is None:
            xp = banded_kernels.solve(self.bstruct, factor.inner,
                                      scaled[self._bperm])
            return self._apply_smw(factor, d * xp[self._biperm].to(rhs.dtype))
        xp = banded_kernels.solve_batched(self.bstruct, factor.inner,
                                          scaled[:, self._bperm], active)
        return self._apply_smw(factor,
                               d * xp[:, self._biperm].to(rhs.dtype))

    def inertia(self, ctx):
        if not self.banded:
            return super().inertia(ctx)
        return banded_inertia(self.bstruct, ctx.factor.inner)

    def zero_context(self):
        if not self.banded:
            return super().zero_context()
        bs = self.bstruct
        factor = EquilibratedFactor(
            inner=bs.zero_factor(self.fact_dtype, self.device),
            d=torch.ones(bs.N, dtype=torch.float64, device=self.device))
        return self._zero_ctx(factor)

    # -- sparse products ---------------------------------------------------

    def jtprod(self, jac_vals, y):
        """jacl = Aᵀy over the full primal space (per lane)."""
        p = self.prob
        if p.m == 0:
            return jac_vals.new_zeros(jac_vals.shape[:-1] + (p.nw,))
        return segment_sum(jac_vals * y[..., self.jr], self._jt_table)

    def jprod(self, jac_vals, v):
        """J·v (per lane)."""
        p = self.prob
        if p.m == 0:
            return jac_vals.new_zeros(jac_vals.shape[:-1] + (0,))
        return segment_sum(jac_vals * v[..., self.jc], self._jp_table)

    def hess_mul(self, hess_vals, v):
        """(…, n) symmetric product from the lower-triangular values, or of
        the compact L-BFGS operator B = diag − UUᵀ + VVᵀ."""
        if isinstance(hess_vals, LowRankHessian):
            lr = hess_vals
            if v.ndim == 1:
                return (lr.diag * v - lr.U @ (lr.U.T @ v)
                        + lr.V @ (lr.V.T @ v))
            vc = v[..., None]
            return (lr.diag * v - (lr.U @ (lr.U.transpose(-1, -2) @ vc))[..., 0]
                    + (lr.V @ (lr.V.transpose(-1, -2) @ vc))[..., 0])
        out = segment_sum(hess_vals * v[..., self.hc], self._hr_table)
        off = torch.where(self.h_offdiag, hess_vals, 0.0)
        return out + segment_sum(off * v[..., self.hr], self._hc_table)

    # -- assembly ----------------------------------------------------------

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False, active=None, prev=None):
        """Assemble and factor.  For a batch, ``active`` (numpy bool (B,))
        selects the lanes to factor and ``prev`` (a batched context or
        None) supplies the other lanes' factor and diagonals.  ``rr`` marks
        the robust-restoration system, whose terms arrive in ``reg`` and
        ``du_diag``; only HYKKT, which the port does not have yet, reads
        it."""
        p = self.prob
        pr_diag, du_diag = self.aug_diagonals(reg, du_diag, dl, du_, zl, zu)
        lowrank = isinstance(hess, LowRankHessian)
        hv = hess.diag if lowrank else hess
        d_k25 = (self._k25_scaling(dl, du_, p.m)
                 if self.opts.kkt_scaling == "k25" else None)
        if not self.banded:
            if active is not None:
                raise _later("batched dense KKT storage")
            K = self._assemble_dense(pr_diag, du_diag, jac, hv)
            factor = self._factorize_matrix(K, d_k25, split=self._split(),
                                            rr=rr)
        else:
            vals = torch.cat([pr_diag, du_diag, jac, hv], -1)
            factor = self._banded_factorize_coo(
                vals, active, None if prev is None else prev.factor, d_k25)
        if lowrank:
            factor = self._attach_smw(
                factor, hess, active,
                None if prev is None else prev.factor)
        if not self.banded:
            return KKTContext(
                hess=hess, jac=jac, pr_diag=pr_diag, du_diag=du_diag,
                reg=reg, dl=dl, du_=du_, zl=zl, zu=zu, factor=factor)
        if prev is not None:
            on = torch.as_tensor(active, device=self.device)[:, None]
            pr_diag = torch.where(on, pr_diag, prev.pr_diag)
            du_diag = torch.where(on, du_diag, prev.du_diag)
            reg = torch.where(on, reg, prev.reg)
        return KKTContext(
            hess=hess, jac=jac, pr_diag=pr_diag, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu, factor=factor,
        )

    # -- operator ----------------------------------------------------------

    def mul(self, ctx: KKTContext, v: KKTVec) -> KKTVec:
        """w = K v with the *unreduced* operator: on the banded path of the
        augmented system the augmented product comes from the stored f64
        operator band, the Σ/bound-dual terms corrected elementwise; with
        dense storage, and for a band that holds another matrix, from the
        sparse products."""
        p = self.prob
        lb, ub = self.lb, self.ub
        if not (self.banded and self._band_is_augmented):
            return self._mul_sparse(ctx, v)
        vfull = torch.cat([v.xp, v.y], -1)
        kv = banded_symv(self.bstruct, ctx.factor.opband,
                         vfull[..., self._bperm])[..., self._biperm]
        sigma = (
            torch.where(lb, ctx.zl / ctx.dl, 0.0)
            + torch.where(ub, ctx.zu / ctx.du_, 0.0)
        )
        wx = kv[..., : p.nw] - sigma * v.xp
        if isinstance(ctx.hess, LowRankHessian):
            corr = _lowrank_corr(ctx.hess, v.xp[..., : p.n])
            wx = torch.cat([wx[..., : p.n] + corr, wx[..., p.n:]], -1)
        wx = wx - torch.where(lb, v.zl, 0.0) + torch.where(ub, v.zu, 0.0)
        wy = kv[..., p.nw:] if p.m > 0 else v.y
        wzl = torch.where(lb, ctx.zl * v.xp + ctx.dl * v.zl, 0.0)
        wzu = torch.where(ub, ctx.zu * v.xp - ctx.du_ * v.zu, 0.0)
        return KKTVec(xp=wx, y=wy, zl=wzl, zu=wzu)

    def _mul_sparse(self, ctx: KKTContext, v: KKTVec) -> KKTVec:
        p = self.prob
        lb, ub = self.lb, self.ub
        hv = self.hess_mul(ctx.hess, v.xp[: p.n])
        wx = torch.cat([hv, hv.new_zeros(p.nw - p.n)])
        wx = wx + ctx.reg * v.xp
        if p.m > 0:
            wx = wx + self.jtprod(ctx.jac, v.y)
            wy = self.jprod(ctx.jac, v.xp) + ctx.du_diag * v.y
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
        ht = self.hess_mul(ctx.hess, t[..., : p.n])
        return (torch.cat([ht, ht.new_zeros(ht.shape[:-1] + (p.nw - p.n,))],
                          -1) + t * ctx.pr_diag)


class SparseCondensedKKT(SparseKKT):
    """Lifted-KKT condensed system ``K = W + Σx + JᵀDJ`` (n×n) with the
    pair-map JᵀDJ assembly — port of ``madnlp_tpu/kkt/sparse.py:
    SparseCondensedKKT`` (the reference's ``SparseCondensedKKTSystem``,
    src/KKT/Sparse/condensed.jl; solve src/IPM/factorization.jl:143-167).

    Every constraint must carry a slack (all-inequality: the RELAX preset
    that ``MadNLPOptions.resolve`` sets for ``SPARSE_CONDENSED``).  The
    pair map has one record per ordered pair of model Jacobian entries
    sharing a row (``ops/banded.py:jtdj_pair_map``); ``K[r, c] +=
    D[k]·J[a]·J[b]`` is a segment sum over it.  The band keeps one record
    per unordered pair (``a ≤ b``); a pair of distinct records in one
    column lands on the diagonal, which the band's symmetrization never
    mirrors, so it counts twice.  The band is ordered by plain RCM (K is
    SPD), and the refinement operator is the sparse products of the
    augmented system.  BLOCK_CHOLESKY and HYKKT become CHOLESKY (no dual
    block).  Inertia rule: ``num_zero == 0 && num_neg == 0``."""

    _band_is_augmented = False   # the band holds the n×n condensed matrix

    def __init__(self, prob, opts):
        if prob.n_eq:
            raise ValueError(
                "SparseCondensedKKT requires all constraints to be "
                "inequalities (use equality_treatment=RELAX / the "
                "SPARSE_CONDENSED preset)")
        super().__init__(prob, opts)
        if self.solver in (LinearSolver.BLOCK_CHOLESKY, LinearSolver.HYKKT):
            # the condensed matrix is plain SPD (no dual block)
            self.solver = LinearSolver.CHOLESKY
        p, dev = prob, self.device
        jr = np.asarray(p.model.jac_rows, dtype=np.int64)
        jc = np.asarray(p.model.jac_cols, dtype=np.int64)
        self.nnz_jac = len(jr)     # model entries (before the slack tail)
        # Jᵀ·buffer by column, J·dx by row (the JAX package's scatter-adds)
        self._mjt_table = torch.as_tensor(segment_map(jc, p.n), device=dev)
        self._mjp_table = torch.as_tensor(segment_map(jr, p.m), device=dev)

    def _pair_map(self):
        p = self.prob
        if not hasattr(self, "_pairs"):
            self._pairs = jtdj_pair_map(np.asarray(p.model.jac_rows),
                                        np.asarray(p.model.jac_cols), p.m)
        return self._pairs

    def _split(self):
        return None

    def _band_ordering(self):
        return None   # the condensed matrix is SPD: plain RCM is stable

    def _band_pattern(self):
        """Lower-COO pattern of K = W + Σx + JᵀDJ in the order of the value
        vector ``[pr_diag[:n], hess, pairs]``, one pair record per
        unordered pair."""
        p, dev = self.prob, self.device
        pr, pc, pa, pb, pk = self._pair_map()
        keep = pa <= pb
        self.bpair_a = torch.as_tensor(pa[keep], device=dev)
        self.bpair_b = torch.as_tensor(pb[keep], device=dev)
        self.bpair_k = torch.as_tensor(pk[keep], device=dev)
        dup_diag = (pr[keep] == pc[keep]) & (pa[keep] != pb[keep])
        self.bpair_w = torch.as_tensor(np.where(dup_diag, 2.0, 1.0),
                                       device=dev)
        diag = np.arange(p.n, dtype=np.int64)
        hr, hc = self._hess_pattern()
        return (np.concatenate([diag, hr, pr[keep]]),
                np.concatenate([diag, hc, pc[keep]]), p.n)

    def _dense_pattern(self):
        """(rows, cols, N) of the dense n×n matrix in the order of the
        value vector ``[pr_diag[:n], hess, hess_off, pairs]`` (every
        ordered pair record at its own position)."""
        p, dev = self.prob, self.device
        pr, pc, pa, pb, pk = self._pair_map()
        self.pair_a = torch.as_tensor(pa, device=dev)
        self.pair_b = torch.as_tensor(pb, device=dev)
        self.pair_k = torch.as_tensor(pk, device=dev)
        diag = np.arange(p.n, dtype=np.int64)
        hr, hc = self._hess_pattern()
        off = self._h_off_np
        return (np.concatenate([diag, hr, hc[off], pr]),
                np.concatenate([diag, hc, hr[off], pc]), p.n)

    def sys_size(self) -> int:
        return self.prob.n

    def _diag_buffer(self, pr_diag, du_diag):
        """D = Σs / (1 − Σd Σs) over the rows (all are inequalities)."""
        sigma_s = pr_diag[self.prob.n:]
        return sigma_s / (1.0 - du_diag * sigma_s)

    def build_and_factorize(self, hess, jac, reg, du_diag, dl, du_, zl, zu,
                            rr: bool = False):
        p = self.prob
        pr_diag, du_diag = self.aug_diagonals(reg, du_diag, dl, du_, zl, zu)
        D = self._diag_buffer(pr_diag, du_diag)
        jv = jac[: self.nnz_jac]      # model entries; the slack tail is in D
        lowrank = isinstance(hess, LowRankHessian)
        hv = hess.diag if lowrank else hess
        if self.banded:
            w = (self.bpair_w * D[self.bpair_k] * jv[self.bpair_a]
                 * jv[self.bpair_b])
            factor = self._banded_factorize_coo(
                torch.cat([pr_diag[: p.n], hv, w]))
        else:
            w = D[self.pair_k] * jv[self.pair_a] * jv[self.pair_b]
            factor = self._factorize_matrix(self._assemble_dense_values(
                torch.cat([pr_diag[: p.n], hv, hv[self._h_off], w])))
        if lowrank:
            factor = self._attach_smw(factor, hess)
        return KKTContext(
            hess=hess, jac=jac, pr_diag=pr_diag, du_diag=du_diag, reg=reg,
            dl=dl, du_=du_, zl=zl, zu=zu, factor=factor)

    def is_inertia_correct(self, pos, zero, neg) -> bool:
        return zero == 0 and neg == 0

    def solve(self, ctx: KKTContext, b: KKTVec) -> KKTVec:
        """Condensed solve (src/IPM/factorization.jl:143-167), the J
        products as segment sums."""
        n = self.prob.n
        w = self.reduce_rhs(ctx, b)
        wx, ws = w.xp[:n], w.xp[n:]
        sigma_s = ctx.pr_diag[n:]
        D = self._diag_buffer(ctx.pr_diag, ctx.du_diag)
        nnz = self.nnz_jac
        jv, jr, jc = ctx.jac[:nnz], self.jr[:nnz], self.jc[:nnz]
        buffer = D * (w.y + ws / sigma_s)
        xx = wx + segment_sum(jv * buffer[jr], self._mjt_table)
        dx = self._backsolve(ctx.factor, xx)
        jdx = segment_sum(jv * dx[jc], self._mjp_table)
        dz = -buffer + D * jdx
        w = w._replace(xp=torch.cat([dx, (ws + dz) / sigma_s]), y=dz)
        return self.finish_aug_solve(ctx, w, b.zl, b.zu)
