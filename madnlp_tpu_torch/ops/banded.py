"""Block-banded LDLᵀ — port of ``madnlp_tpu/ops/banded.py``: the host-side
symbolic phase and the plain PyTorch versions of the device functions.

The KKT pattern is permuted (RCM with a quasidefinite-preserving dual
interleave) to concentrate it inside a narrow band, and the factor is a
right-looking *block-banded* unpivoted LDLᵀ:

* storage: ``band (nb + bw, bw + 1, b, b)`` with ``band[j, k]`` = dense
  block ``(j + k, j)`` of the permuted matrix; ``band[j, 0]`` is
  lower-stored;
* per block column j: LDLᵀ and L⁻¹ of the diagonal block, the panel
  ``X = P·L_jj⁻ᵀ``, ``Lcol = X·D_j⁻¹``, and the trailing update
  ``band[j+l, m] −= Lcol_{l+m}·X_lᵀ`` of the next ``bw`` columns;
* a pivot with ``|d| <= ZERO_PIVOT_TOL`` divides as inf and counts as zero
  in the inertia, which drives the IPM's δ-regularization ladder.

The plain factorization follows the algorithm of the TPU kernel
(``madnlp_tpu/ops/pallas_banded_stream.py:_stream_factorize_kernel``), whose
diagonal step is the panel-blocked LDLᵀ + L⁻¹ of
``madnlp_tpu/ops/pallas_banded.py:_ldlt_with_inverse`` (panel p = 32): a
scalar pivot recursion on a p×2p corner, then panel, trailing and
L⁻¹-accumulation products.  These functions run on any device; the solver
reaches them through :mod:`.banded_kernels`, which takes them only for a
tensor on the CPU and launches the CUDA kernels for a tensor on the card.

Assembly from COO values is deterministic: a host-sorted, padded
contributor gather and a sum along the contributor axis
(:class:`BandAssembly`), then one placement at unique slots.

A batch of same-structure systems (``solve_batch``) carries a leading
lane axis on every band, factor and right-hand side; the assembly, the
operator and the scaling functions broadcast over it, and
:func:`banded_factorize_batched` / :func:`banded_solve_batched` are the
plain versions of the batched kernels K3 / K4, which factor and solve only
the lanes an ``active`` mask selects.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .segment import segment_map, segment_sum

# Absolute threshold below which a pivot is declared zero (the JAX
# package's ops/ldlt.py:ZERO_PIVOT_TOL).
ZERO_PIVOT_TOL = 1e-30

#: Corner width of the panel-blocked diagonal factorization.
PANEL = 32


class BandedFactor(NamedTuple):
    """Factor payload: L (unit block-lower, band layout) + D + per-column
    inverted diagonal blocks (so backsolves are pure mat-vecs)."""

    band: torch.Tensor   # (nbp, bw+1, b, b): [j,0]=tril(L_jj,-1)+diag(d_j), [j,k]=L_{j+k,j}
    invL: torch.Tensor   # (nbp, b, b) inverses of the unit-lower diagonal blocks
    d: torch.Tensor      # (nb*b,) pivots (padded tail entries = 1)


# -- host-side symbolic phase -------------------------------------------------


def jtdj_pair_map(rows: np.ndarray, cols: np.ndarray, m: int):
    """Pair map of JᵀDJ: (pr, pc, pa, pb, pk) int64 arrays with one record
    per ordered pair of Jacobian entries sharing a row (a copy of the JAX
    package's numpy ``native/__init__.py:_jtdj_pair_map_numpy``)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=m)
    rowptr = np.concatenate([[0], np.cumsum(counts)])
    pr, pc, pa, pb, pk = [], [], [], [], []
    for k in np.unique(counts):
        if k == 0:
            continue
        rws = np.nonzero(counts == k)[0]
        starts = rowptr[rws]
        ent = order[starts[:, None] + np.arange(k)[None, :]]   # (nrows, k)
        a = np.repeat(ent, k, axis=1)
        b = np.tile(ent, (1, k))
        pa.append(a.reshape(-1))
        pb.append(b.reshape(-1))
        pr.append(cols[a].reshape(-1))
        pc.append(cols[b].reshape(-1))
        pk.append(np.repeat(rws, k * k))

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)

    return cat(pr), cat(pc), cat(pa), cat(pb), cat(pk)


def rcm_ordering(rows: np.ndarray, cols: np.ndarray, N: int) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrized pattern; returns ``perm``
    with ``K_perm[i, j] = K[perm[i], perm[j]]``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    data = np.ones(2 * len(rows) + N)
    r = np.concatenate([rows, cols, np.arange(N)])
    c = np.concatenate([cols, rows, np.arange(N)])
    A = sp.csr_matrix((data, (r, c)), shape=(N, N))
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True), dtype=np.int64)


def kkt_interleaved_ordering(
    hess_rows, hess_cols, jac_rows, jac_cols, nw: int, m: int
) -> np.ndarray:
    """Quasidefinite-preserving band ordering for the augmented KKT
    ``[W+Σ Jᵀ; J -δI]``: RCM over the *primal* connectivity (Hessian
    pattern + JᵀJ cliques), with each dual row inserted immediately after
    the last primal variable its constraint touches, so that unpivoted
    LDLᵀ meets each constraint row only after its full (negative) Schur
    contribution has arrived."""
    jac_rows = np.asarray(jac_rows, dtype=np.int64)
    jac_cols = np.asarray(jac_cols, dtype=np.int64)
    pr, pc, _, _, _ = jtdj_pair_map(jac_rows, jac_cols, m)
    rows = np.concatenate([np.asarray(hess_rows, dtype=np.int64), pr])
    cols = np.concatenate([np.asarray(hess_cols, dtype=np.int64), pc])
    prim_perm = rcm_ordering(rows, cols, nw)
    prim_pos = np.empty(nw, dtype=np.int64)
    prim_pos[prim_perm] = np.arange(nw)
    con_pos = np.zeros(m, dtype=np.int64)
    np.maximum.at(con_pos, jac_rows, prim_pos[jac_cols])
    # stable interleave: primal var at position t gets key 2t, constraint k
    # key 2·con_pos[k]+1 (i.e. right after its last variable)
    keys = np.concatenate([2 * prim_pos, 2 * con_pos + 1])
    return np.argsort(keys, kind="stable").astype(np.int64)


class BandStructure:
    """Host-side symbolic phase: ordering + band geometry + the
    COO → flat-band index map."""

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        N: int,
        block: int,
        perm: np.ndarray = None,
    ):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        self.N = int(N)
        self.b = int(block)
        if perm is None:
            perm = rcm_ordering(rows, cols, N)
        perm = np.asarray(perm, dtype=np.int64)
        iperm = np.empty(N, dtype=np.int64)
        iperm[perm] = np.arange(N)
        self.perm = perm          # K_perm[i, j] = K[perm[i], perm[j]]
        self.iperm = iperm
        W = int(np.abs(iperm[rows] - iperm[cols]).max(initial=0))
        self.W = W                # scalar bandwidth
        b = self.b
        self.bw = max(1, -(-W // b)) if W > 0 else 1
        self.nb = max(1, -(-N // b))
        self.nbp = self.nb + self.bw
        self.flat_size = self.nbp * (self.bw + 1) * b * b
        # identity padding on the scalar tail of the last real block
        pad = np.arange(N, self.nb * b, dtype=np.int64)
        self.pad_idx = self._map_permuted(pad, pad)

    @property
    def shape(self):
        return (self.nbp, self.bw + 1, self.b, self.b)

    def zero_factor(self, dtype, device) -> "BandedFactor":
        """The zero factor of this geometry (pivots 1): the persisted
        context of a solve that has factored nothing yet."""
        b, nbp = self.b, self.nbp
        return BandedFactor(
            band=torch.zeros(self.shape, dtype=dtype, device=device),
            invL=torch.zeros((nbp, b, b), dtype=dtype, device=device),
            d=torch.ones((self.nb * b,), dtype=dtype, device=device))

    def _map_permuted(self, pr, pc):
        lo = np.minimum(pr, pc)
        hi = np.maximum(pr, pc)
        b, bw = self.b, self.bw
        j = lo // b
        k = hi // b - j
        if not (k <= bw).all():
            raise ValueError("entry outside the block band")
        return ((j * (bw + 1) + k) * b + (hi - (j + k) * b)) * b + (lo - j * b)

    def map(self, rows, cols) -> np.ndarray:
        """Flat band indices for (lower-or-upper) COO coordinates in the
        ORIGINAL ordering.  Symmetric duplicates must not be passed twice."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        return self._map_permuted(self.iperm[rows], self.iperm[cols])

    def assembly(self, flat_idx: np.ndarray, device) -> "BandAssembly":
        """Deterministic COO → band assembly for the given index map, with
        the identity padding riding along as constant 1.0 contributors."""
        return BandAssembly(
            np.concatenate([np.asarray(flat_idx, np.int64), self.pad_idx]),
            len(self.pad_idx), self.flat_size, self.shape, device,
        )


class BandAssembly:
    """COO values → band storage, the same sum order on every run.

    Host side: the distinct target slots, and for each a padded row of its
    contributors (input order).  Device side: one gather, one sum along the
    contributor axis, one placement at unique slots.  A scatter-add would
    sum duplicates by atomics on CUDA, in a varying order."""

    def __init__(self, idx, n_pad_ones, flat_size, shape, device):
        slots, inverse = np.unique(np.asarray(idx, np.int64),
                                   return_inverse=True)
        self.n_pad_ones = n_pad_ones
        self.flat_size = flat_size
        self.shape = shape
        self.slots = torch.as_tensor(slots, device=device)
        self.table = torch.as_tensor(segment_map(inverse, len(slots)),
                                     device=device)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        """``vals (…, nnz)`` -> band ``(…, nbp, bw+1, b, b)``."""
        lead = vals.shape[:-1]
        ext = torch.cat([vals, vals.new_ones(lead + (self.n_pad_ones,))], -1)
        flat = vals.new_zeros(lead + (self.flat_size,))
        flat[..., self.slots] = segment_sum(ext, self.table)
        return flat.view(lead + tuple(self.shape))


# -- plain device functions ---------------------------------------------------


def pivot_div(d):
    """Pivot divisor: |d| <= ZERO_PIVOT_TOL divides as inf.  ``d`` is a
    tensor or one pivot read from a :func:`host_view`: the branch follows
    the type that ``host_view`` chose, and never looks at a device."""
    if not torch.is_tensor(d):
        return math.inf if abs(d) <= ZERO_PIVOT_TOL else d
    return torch.where(d.abs() <= ZERO_PIVOT_TOL, math.inf, d)


def host_view(t: torch.Tensor):
    """A CPU tensor's memory as a numpy array, any other tensor as it is.

    This is the one place where a plain version's scalar recursion forks
    by device: every such recursion (``_corner_ldlt`` here,
    ``ops/ldlt.py:ldlt_unblocked``, ``ops/dense_kernels.py``'s unit-lower
    inverse) indexes the array this returns and nothing else, so there are
    exactly two variants, numpy on the CPU and torch on the card.  numpy
    does the same IEEE operations in the same order at a fraction of
    torch's cost per call, so the bits are the same
    (``tests/test_torch_banded.py::test_host_recursions_are_the_torch_steps_bit_for_bit``)."""
    return t.detach().numpy() if t.device.type == "cpu" else t


def _corner_ldlt(C: torch.Tensor):
    """LDLᵀ + L⁻¹ of a FULL-symmetric (p, p) corner by the scalar pivot
    recursion on ``[C | I]`` (pallas_banded.py:_corner_ldlt).  Returns
    ``(M_left, invL_c)``: M_left holds l below the diagonal and d on it."""
    p = C.shape[0]
    M = torch.cat([C, torch.eye(p, dtype=C.dtype, device=C.device)], dim=1)
    A = host_view(M)
    for j in range(p - 1):
        lj = A[j + 1:, j] / pivot_div(A[j, j])
        A[j + 1:, j + 1:] -= lj[:, None] * A[j, j + 1:][None, :]
        A[j + 1:, j] = lj
    return M[:, :p], M[:, p:]


def ldlt_with_inverse(A: torch.Tensor, panel: int = PANEL):
    """Panel-blocked (b, b) LDLᵀ + L⁻¹ of a LOWER-stored symmetric block
    (pallas_banded.py:_ldlt_with_inverse).  Only the lower triangle of
    ``A`` is read.  Returns ``(LD, invL)`` with LD = strict-lower L + D on
    the diagonal (upper triangle zero)."""
    b = A.shape[0]
    p = panel
    if b % p:
        raise ValueError(f"block size {b} is not a multiple of the panel {p}")
    L = A.clone()
    R = torch.eye(b, dtype=A.dtype, device=A.device)
    for lo in range(0, b, p):
        hi = lo + p
        C = L[lo:hi, lo:hi]
        LDc, invLc = _corner_ldlt(torch.tril(C) + torch.tril(C, -1).T)
        dc = torch.diagonal(LDc).clone()
        LDc = torch.tril(LDc, -1) + torch.diag(dc)
        X = L[hi:, lo:hi] @ invLc.T                     # (b-hi, p)
        Lc = X / pivot_div(dc)
        L[hi:, hi:] -= Lc @ X.T                         # trailing update
        Zr = invLc @ R[lo:hi, :hi]                      # L⁻¹ accumulation
        R[hi:, :hi] -= Lc @ Zr
        R[lo:hi, :hi] = Zr
        L[:lo, lo:hi] = 0.0
        L[lo:hi, lo:hi] = LDc
        L[hi:, lo:hi] = Lc
    return L, R


def factorize_columns(band, invL, d, nb: int, b: int, bw: int):
    """Plain version of the K1 kernel (``banded_kernels.banded_factorize_cuda``):
    factor block columns 0..nb-1 of ``band`` IN PLACE, writing ``invL[j]``
    and ``d[j*b:(j+1)*b]``.  Overhang columns ``>= nb`` receive trailing
    updates but are never factored; ``invL`` and ``d`` keep their values
    there."""
    for j in range(nb):
        LD, iL = ldlt_with_inverse(band[j, 0])
        dk = torch.diagonal(LD).clone()
        X = band[j, 1:].reshape(bw * b, b) @ iL.T       # (bw·b, b)
        Lcol = X / pivot_div(dk)
        for l in range(1, bw + 1):
            Xl = X[(l - 1) * b:l * b]
            for m in range(bw - l + 1):
                band[j + l, m] -= Lcol[(l + m - 1) * b:(l + m) * b] @ Xl.T
        band[j, 0] = LD
        band[j, 1:] = Lcol.reshape(bw, b, b)
        invL[j] = iL
        d[j * b:(j + 1) * b] = dk
    return band, invL, d


def banded_factorize(struct: BandStructure, band: torch.Tensor) -> BandedFactor:
    """Right-looking block-banded LDLᵀ (plain); ``band`` from an assembly.
    The input is not modified."""
    b, bw, nb, nbp = struct.b, struct.bw, struct.nb, struct.nbp
    out = band.clone()
    invL = band.new_zeros((nbp, b, b))
    d = band.new_ones((nbp * b,))
    factorize_columns(out, invL, d, nb, b, bw)
    return BandedFactor(band=out, invL=invL, d=d[: nb * b])


def solve_padded(band, invL, d, rhs):
    """Plain version of the K2 kernel (``banded_kernels.banded_solve_cuda``):
    solve IN PLACE on ``rhs (nbp·b, k)`` (permuted coordinates, zero
    padded).  Forward sweep ``z_j = invL_j·r_j``, ``r_{j+1..j+bw} −= P_j·z_j``,
    then ``D⁻¹``, then the backward sweep
    ``x_j = invL_jᵀ·(z_j − P_jᵀ·x_{j+1..j+bw})``.  The padding rows of the
    result are zero."""
    nbp, bw1, b, _ = band.shape
    bw = bw1 - 1
    nb = nbp - bw
    ddiv = pivot_div(d[: nb * b])
    for j in range(nb):
        zj = invL[j] @ rhs[j * b:(j + 1) * b]
        Pj = band[j, 1:].reshape(bw * b, b)
        rhs[(j + 1) * b:(j + 1 + bw) * b] -= Pj @ zj
        rhs[j * b:(j + 1) * b] = zj / ddiv[j * b:(j + 1) * b, None]
    rhs[nb * b:] = 0.0
    for j in range(nb - 1, -1, -1):
        Pj = band[j, 1:].reshape(bw * b, b)
        tj = rhs[j * b:(j + 1) * b] - Pj.T @ rhs[(j + 1) * b:(j + 1 + bw) * b]
        rhs[j * b:(j + 1) * b] = invL[j].T @ tj
    return rhs


def factorize_columns_batched(band, invL, d, active, nb: int, b: int,
                              bw: int):
    """Plain version of the K3 kernel
    (``banded_kernels.banded_factorize_batched_cuda``): K1's plain version
    on each lane of ``band (B, nbp, bw+1, b, b)``, ``invL (B, nbp, b, b)``
    and ``d (B, nb·b)`` whose ``active`` (B,) entry is true, in place;
    inactive lanes are left untouched."""
    for i in np.flatnonzero(np.asarray(active, dtype=bool)):
        factorize_columns(band[i], invL[i], d[i], nb, b, bw)
    return band, invL, d


def solve_padded_batched(band, invL, d, rhs, active):
    """Plain version of the K4 kernel
    (``banded_kernels.banded_solve_batched_cuda``): K2's plain version on
    each active lane of ``rhs (B, nbp·b, k)``, in place; inactive lanes
    are left untouched."""
    for i in np.flatnonzero(np.asarray(active, dtype=bool)):
        solve_padded(band[i], invL[i], d[i], rhs[i])
    return rhs


def banded_factorize_batched(struct: BandStructure, band: torch.Tensor,
                             active=None) -> BandedFactor:
    """Plain batched factorization of ``band (B, nbp, bw+1, b, b)``: a
    :class:`BandedFactor` with a leading lane axis (``d (B, nb·b)``).  The
    input is not modified; inactive lanes come back as their input band
    with ``invL = 0`` and ``d = 1``."""
    B = band.shape[0]
    b, nb = struct.b, struct.nb
    active = np.ones(B, dtype=bool) if active is None else active
    out = band.clone()
    invL = band.new_zeros((B, struct.nbp, b, b))
    d = band.new_ones((B, nb * b))
    factorize_columns_batched(out, invL, d, active, nb, b, struct.bw)
    return BandedFactor(band=out, invL=invL, d=d)


def pad_rhs(struct: BandStructure, rhs: torch.Tensor) -> torch.Tensor:
    """(N,) or (N, k) permuted rhs -> zero-padded ``(nbp·b, k)``."""
    r = rhs[:, None] if rhs.ndim == 1 else rhs
    work = r.new_zeros((struct.nbp * struct.b, r.shape[1]))
    work[: struct.N] = r
    return work


def banded_solve(struct: BandStructure, f: BandedFactor, rhs: torch.Tensor):
    """Solve in PERMUTED coordinates (plain); ``rhs``: (N,) or (N, k)."""
    x = solve_padded(f.band, f.invL, f.d, pad_rhs(struct, rhs))[: struct.N]
    return x[:, 0] if rhs.ndim == 1 else x


def pad_rhs_batched(struct: BandStructure, rhs: torch.Tensor) -> torch.Tensor:
    """(B, N) or (B, N, k) permuted rhs -> zero-padded ``(B, nbp·b, k)``."""
    r = rhs[..., None] if rhs.ndim == 2 else rhs
    work = r.new_zeros((r.shape[0], struct.nbp * struct.b, r.shape[2]))
    work[:, : struct.N] = r
    return work


def banded_solve_batched(struct: BandStructure, f: BandedFactor,
                         rhs: torch.Tensor, active=None):
    """Plain batched solve in PERMUTED coordinates; ``rhs`` (B, N) or
    (B, N, k).  Inactive lanes return their right-hand side."""
    active = np.ones(rhs.shape[0], dtype=bool) if active is None else active
    work = pad_rhs_batched(struct, rhs)
    solve_padded_batched(f.band, f.invL, f.d, work, active)
    x = work[:, : struct.N]
    return x[..., 0] if rhs.ndim == 2 else x


def banded_inertia(struct: BandStructure, f: BandedFactor):
    """(pos, zero, neg) from the pivot signs, padding removed; for a
    batched factor (``d (B, nb·b)``) an int64 array ``(B, 3)``, read from
    the device at once."""
    pad = struct.nb * struct.b - struct.N
    finite = torch.isfinite(f.d)
    pos_neg = torch.stack([
        ((f.d > ZERO_PIVOT_TOL) & finite).sum(-1),
        ((f.d < -ZERO_PIVOT_TOL) & finite).sum(-1),
    ], -1).cpu().numpy()
    pos = pos_neg[..., 0] - pad
    neg = pos_neg[..., 1]
    if f.d.ndim == 1:
        return int(pos), int(struct.N - pos - neg), int(neg)
    return np.stack([pos, struct.N - pos - neg, neg], -1)


def banded_symmetrize(struct: BandStructure, band: torch.Tensor) -> torch.Tensor:
    """Complete the (lower-stored) diagonal blocks to full symmetric — the
    operator form consumed by :func:`banded_symv`."""
    b0 = band[..., 0, :, :]
    eye = torch.eye(struct.b, dtype=band.dtype, device=band.device)
    out = band.clone()
    out[..., 0, :, :] = b0 + b0.transpose(-1, -2) * (1.0 - eye)
    return out


def banded_symv(struct: BandStructure, band_sym: torch.Tensor, x: torch.Tensor):
    """Symmetric block-banded mat-vec ``y = K·x`` in PERMUTED coordinates:
    batched (nbp, b, b)×(nbp, b) products over the ``bw+1`` block
    diagonals.  ``x``: (…, N)."""
    b, bw, nbp, N = struct.b, struct.bw, struct.nbp, struct.N
    lead = x.shape[:-1]
    xb = x.new_zeros(lead + (nbp * b,))
    xb[..., :N] = x
    xb = xb.view(lead + (nbp, b))
    y = torch.einsum("...jab,...jb->...ja", band_sym[..., 0, :, :], xb)
    for k in range(1, bw + 1):
        # block (j+k, j) · x_j, then block (j, j+k)ᵀ · x_{j+k}
        blk = band_sym[..., : nbp - k, k, :, :]
        y[..., k:, :] += torch.einsum("...jab,...jb->...ja", blk,
                                      xb[..., : nbp - k, :])
        y[..., : nbp - k, :] += torch.einsum("...jba,...jb->...ja", blk,
                                             xb[..., k:, :])
    return y.reshape(lead + (-1,))[..., :N]


def ruiz_band(struct: BandStructure, band_sym: torch.Tensor, sweeps: int = 3):
    """Ruiz equilibration computed directly on the (symmetrized) band.
    Returns the scaling in PERMUTED block layout, shape (…, nbp, b).
    Structurally-zero rows keep d = 1 (iterating d ← d/√(row-norm) on a
    zero row diverges)."""
    b, bw, nbp = struct.b, struct.bw, struct.nbp
    d = band_sym.new_ones(band_sym.shape[:-4] + (nbp, b))
    absb = band_sym.abs()
    for _ in range(sweeps):
        rn = (absb[..., 0, :, :] * d[..., :, :, None]
              * d[..., :, None, :]).amax(dim=-1)
        for k in range(1, bw + 1):
            ak = (absb[..., : nbp - k, k, :, :] * d[..., k:, :, None]
                  * d[..., : nbp - k, None, :])
            rn[..., k:, :] = torch.maximum(rn[..., k:, :], ak.amax(dim=-1))
            rn[..., : nbp - k, :] = torch.maximum(rn[..., : nbp - k, :],
                                                  ak.amax(dim=-2))
        d = torch.where(rn > 0.0, d / torch.sqrt(torch.clamp_min(rn, 1e-32)), 1.0)
    return d


def scale_band(struct: BandStructure, band: torch.Tensor, d: torch.Tensor):
    """Congruence scaling D·K·D applied to (lower-stored) band storage;
    ``d``: (…, nbp, b) permuted scaling from :func:`ruiz_band`."""
    b, bw, nbp = struct.b, struct.bw, struct.nbp
    dpad = torch.cat([d, d.new_ones(d.shape[:-2] + (bw, b))], dim=-2)
    return torch.stack(
        [band[..., k, :, :] * dpad[..., k:k + nbp, :, None]
         * d[..., :, None, :] for k in range(bw + 1)],
        dim=-3,
    )
