"""Sparse .nl compilation, the template compiler — port of
``madnlp_tpu/models/nl_sparse.py`` (``compile_sparse`` and its passes).

The dense ``.nl`` path (:func:`.nl.read_nl`) densifies: a dense linear
matrix and dense ``torch.func`` Jacobians and Hessians, O(n·m) memory and
O(n²) AD work.  This module compiles the same parsed expression graphs
into a :class:`~.model.SparseNLPModel` with exact COO derivative sparsity
and nnz-sized evaluation:

1. **Inline** defined variables (V segments) so locality analysis sees
   plain variable leaves.
2. **Split** each constraint/objective graph into additive *terms*
   (flattening ``+``, ``-``, unary minus, OPSUMLIST).  AMPL/Pyomo models
   are sums of small indexed terms, so each term touches few variables.
3. **Canonicalize** each term: variable ids and numeric constants become
   slot references; the remaining pure structure is the *template* key.
   (``pow`` exponents stay frozen in the key — linearity depends on them.)
4. **Group** terms by template.  Per group, ONE local function of the slot
   vector, and its gradient and Hessian (``torch.func.grad`` /
   ``torch.func.hessian``) ``torch.func.vmap``-ed over the stacked
   per-term data arrays.
5. **Hessian sparsity** comes from slot-level linearity propagation over
   the template AST (which slot pairs can have a nonzero second
   derivative), mapped through each term's variable ids, with the
   duplicate-COO convention of the KKT layer (diagonal-landing off-slot
   pairs weighted ×2, lower-triangular storage).

Where the JAX package sums the terms of a constraint row or of a gradient
entry with scatter-adds, the port sums them through host-built segment
maps (:mod:`..ops.segment`), in the same order on every run and device;
the two packages' sums then differ in order only.  The groups' data lives
host-side and is copied once to each device that evaluates it
(:class:`~.model.DeviceConstants`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.segment import segment_map, segment_sum
from .model import DeviceConstants, SparseNLPModel
from .nl import _BINARY, _NARY, _RELATIONAL, _UNARY, ParsedNL, _apply

# ---------------------------------------------------------------------------
# defined-variable inlining
# ---------------------------------------------------------------------------


def _inline_defined(parsed: ParsedNL):
    """Return (con_exprs, obj_exprs) with every defined-variable reference
    (index >= n_var) replaced by its defining expression.  .nl guarantees
    definition-before-use order, so one forward pass suffices."""
    n_var = parsed.n_var
    defmap = {}
    for vi, lin, expr in parsed.defined:
        body = _substitute(expr, defmap, n_var)
        for v, cf in lin:
            leaf = _substitute(("var", v), defmap, n_var)
            body = (0, (body, (2, (("const", cf), leaf))))
        defmap[vi] = body

    cons = [None if e is None else _substitute(e, defmap, n_var)
            for e in parsed.con_expr]
    objs = [None if e is None else _substitute(e, defmap, n_var)
            for e in parsed.obj_expr]
    return cons, objs


def _substitute(node, defmap, n_var):
    kind, payload = node
    if kind == "const":
        return node
    if kind == "var":
        if payload >= n_var:
            return defmap[payload]
        return node
    return (kind, tuple(_substitute(c, defmap, n_var) for c in payload))


# ---------------------------------------------------------------------------
# additive term splitting
# ---------------------------------------------------------------------------


def _split_terms(node, sign=1.0, out=None):
    """Flatten +/−/neg/OPSUMLIST chains into [(sign, term_ast)]."""
    if out is None:
        out = []
    kind, payload = node
    if kind == 0:                       # add
        _split_terms(payload[0], sign, out)
        _split_terms(payload[1], sign, out)
    elif kind == 1:                     # subtract
        _split_terms(payload[0], sign, out)
        _split_terms(payload[1], -sign, out)
    elif kind == 16:                    # negate
        _split_terms(payload[0], -sign, out)
    elif kind == 54:                    # OPSUMLIST
        for c in payload:
            _split_terms(c, sign, out)
    else:
        out.append((sign, node))
    return out


# ---------------------------------------------------------------------------
# template canonicalization
# ---------------------------------------------------------------------------


def _canon(node, var_slots: List[int], const_slots: List[float]):
    """Rewrite leaves into slot references; returns the canonical AST.
    ``pow`` exponents that are constants stay frozen in the structure
    (integer-power exactness for AD and linearity-correct Hessian pattern)."""
    kind, payload = node
    if kind == "const":
        const_slots.append(float(payload))
        return ("cslot", len(const_slots) - 1)
    if kind == "var":
        var_slots.append(int(payload))
        return ("vslot", len(var_slots) - 1)
    if kind == 5 and payload[1][0] == "const":
        base = _canon(payload[0], var_slots, const_slots)
        return (5, (base, ("const", float(payload[1][1]))))
    return (kind, tuple(_canon(c, var_slots, const_slots) for c in payload))


def _eval_canon(node, zv, zc):
    """Evaluate a canonical AST against the slot vectors of one term."""
    kind, payload = node
    if kind == "vslot":
        return zv[payload]
    if kind == "cslot":
        return zc[payload]
    if kind == "const":
        return payload
    args = [_eval_canon(c, zv, zc) for c in payload]
    return _apply(kind, payload, args, zc)


# ---------------------------------------------------------------------------
# Hessian-sparsity propagation (slot level)
# ---------------------------------------------------------------------------

_ZERO_DERIV_UNARY = {13, 14}            # floor, ceil: derivative 0 a.e.
_PIECEWISE_LINEAR_UNARY = {15}          # abs: second derivative 0 a.e.


def _cross(a, b):
    return {(max(i, j), min(i, j)) for i in a for j in b}


def _hess_pairs(node) -> Tuple[frozenset, frozenset]:
    """Return (vars, pairs): the slot ids the node's derivative can depend
    on, and the slot pairs (a>=b) with a possibly-nonzero second derivative.
    Constants (cslot/frozen const) carry no variables, so scaling by data
    stays linear automatically."""
    kind, payload = node
    if kind in ("cslot", "const"):
        return frozenset(), frozenset()
    if kind == "vslot":
        return frozenset([payload]), frozenset()
    sub = [_hess_pairs(c) for c in payload]
    if kind in (0, 1, 54):              # add, subtract, sumlist
        return (frozenset().union(*(v for v, _ in sub)),
                frozenset().union(*(p for _, p in sub)))
    if kind == 16:                      # negate
        return sub[0]
    if kind == 2:                       # multiply
        (va, pa), (vb, pb) = sub
        return va | vb, pa | pb | _cross(va, vb)
    if kind in (3, 4, 55):              # divide, rem, int div
        (va, pa), (vb, pb) = sub
        if kind == 55:                  # trunc(a/b): derivative 0 a.e.
            return frozenset(), frozenset()
        if not vb:
            return va, pa               # divide/rem by data: linearity kept
        if kind == 4:                   # rem: a − b·trunc(a/b), linear a.e.
            return va | vb, pa | pb
        v = va | vb
        return v, pa | pb | _cross(va, vb) | _cross(vb, vb)
    if kind == 5:                       # pow
        (va, pa) = sub[0]
        expo = payload[1]
        if expo[0] == "const":
            e = float(expo[1])
            if e == 0.0:
                return frozenset(), frozenset()
            if e == 1.0:
                return va, pa
            return va, pa | _cross(va, va)
        vb, pb = sub[1]
        v = va | vb
        return v, pa | pb | _cross(v, v)
    if kind == 48:                      # arctan2
        (va, pa), (vb, pb) = sub
        v = va | vb
        return v, pa | pb | _cross(v, v)
    if kind == 6:                       # `less`: max(a−b, 0), piecewise linear
        (va, pa), (vb, pb) = sub
        return va | vb, pa | pb
    if kind in (11, 12):                # min/max lists: piecewise
        return (frozenset().union(*(v for v, _ in sub)),
                frozenset().union(*(p for _, p in sub)))
    if kind in _ZERO_DERIV_UNARY:
        return frozenset(), frozenset()
    if kind in _PIECEWISE_LINEAR_UNARY:
        return sub[0]
    if kind in _UNARY:                  # smooth nonlinear unary
        va, pa = sub[0]
        return va, pa | _cross(va, va)
    if kind in _RELATIONAL or kind in (20, 21, 34):
        return frozenset(), frozenset()  # boolean: derivative 0 a.e.
    if kind == 35:                      # if(c, t, e): piecewise in t/e
        (_, _), (vt, pt), (ve, pe) = sub
        return vt | ve, pt | pe
    raise AssertionError(f"unreachable opcode {kind}")


# ---------------------------------------------------------------------------
# group compilation
# ---------------------------------------------------------------------------


class _Group:
    """All terms sharing one template: stacked slot data + static maps.
    Objective and constraint terms never share a group (the key is tagged)
    so the Hessian weight is uniformly ``obj_weight`` or ``y[rows]``."""

    def __init__(self, key, is_obj):
        self.key = key                  # canonical AST
        self.is_obj = is_obj
        self.rows: List[int] = []       # constraint index (−1 = objective)
        self.signs: List[float] = []
        self.var_ids: List[List[int]] = []
        self.consts: List[List[float]] = []

    def finalize(self):
        self.rows = np.asarray(self.rows, dtype=np.int64)
        self.signs = np.asarray(self.signs, dtype=np.float64)
        self.var_ids = np.asarray(self.var_ids, dtype=np.int64)
        if self.var_ids.ndim == 1:      # zero var slots
            self.var_ids = self.var_ids.reshape(len(self.rows), 0)
        self.consts = np.asarray(self.consts, dtype=np.float64)
        if self.consts.ndim == 1:
            self.consts = self.consts.reshape(len(self.rows), 0)

        # hessian pair slots (static, shared by all members)
        _, pairs = _hess_pairs(self.key)
        self.pairs = sorted(pairs)
        if self.pairs:
            pa = np.array([p[0] for p in self.pairs])
            pb = np.array([p[1] for p in self.pairs])
            ra = self.var_ids[:, pa]            # (G, npairs) global var ids
            rb = self.var_ids[:, pb]
            self.hrows = np.maximum(ra, rb)
            self.hcols = np.minimum(ra, rb)
            # distinct slots landing on one variable: the symmetric mirror
            # H[b,a] folds onto the diagonal — weight ×2 (cf. the duplicate-
            # record convention in kkt/sparse.py assembly)
            self.hweight = np.where((pa != pb) & (ra == rb), 2.0, 1.0)
            self.pa, self.pb = pa, pb
        else:
            self.hrows = np.zeros((len(self.rows), 0), dtype=np.int64)
            self.hcols = np.zeros((len(self.rows), 0), dtype=np.int64)
            self.hweight = np.zeros((len(self.rows), 0))
            self.pa = self.pb = np.zeros((0,), dtype=np.int64)

        key = self.key
        nvs = self.var_ids.shape[1]

        def local(zv, zc):
            return _eval_canon(key, zv, zc)

        self.fn = torch.func.vmap(local)
        self.grad_fn = (torch.func.vmap(torch.func.grad(local, argnums=0))
                        if nvs else None)
        self.hess_fn = (
            torch.func.vmap(torch.func.hessian(local, argnums=0))
            if len(self.pairs) else None
        )


def _collect_groups(exprs_with_rows, groups: Dict, offsets: np.ndarray):
    """Split each (row, expr) into terms and register them in ``groups``;
    constant terms accumulate into ``offsets`` (objective row −1 maps to
    offsets[-1], an extra trailing cell)."""
    for row, expr in exprs_with_rows:
        if expr is None:
            continue
        for sign, term in _split_terms(expr):
            if term[0] == "const":
                offsets[row] += sign * term[1]
                continue
            var_slots: List[int] = []
            const_slots: List[float] = []
            key = (row < 0, _canon(term, var_slots, const_slots))
            g = groups.get(key)
            if g is None:
                g = groups[key] = _Group(key[1], is_obj=key[0])
            g.rows.append(row)
            g.signs.append(sign)
            g.var_ids.append(var_slots)
            g.consts.append(const_slots)


def compile_sparse(parsed: ParsedNL, objno: int = 0) -> SparseNLPModel:
    """Compile a parsed .nl file into a :class:`SparseNLPModel`."""
    n, m = parsed.n_var, parsed.n_con
    con_exprs, obj_exprs = _inline_defined(parsed)
    maximize = parsed.obj_sense[objno] == 1

    offsets = np.zeros(m + 1)           # [-1] = objective constant
    groups: Dict = {}
    _collect_groups(
        [(i, e) for i, e in enumerate(con_exprs)], groups, offsets)
    _collect_groups([(-1, obj_exprs[objno])], groups, offsets)
    glist = list(groups.values())
    for g in glist:
        g.finalize()
    con_groups = [g for g in glist if not g.is_obj]
    obj_groups = [g for g in glist if g.is_obj]

    # ---- linear parts (sparse COO, static) -------------------------------
    # (AMPL J segments carry a 0.0 linear coefficient for purely nonlinear
    # entries — drop those; the nonlinear groups already cover them)
    lin_rows, lin_cols, lin_vals = [], [], []
    for i, terms in enumerate(parsed.jac_lin):
        for v, cf in terms:
            if cf != 0.0:
                lin_rows.append(i)
                lin_cols.append(v)
                lin_vals.append(cf)
    lin_rows = np.asarray(lin_rows, dtype=np.int64)
    lin_cols = np.asarray(lin_cols, dtype=np.int64)
    lin_vals = np.asarray(lin_vals)
    g0 = [(v, cf) for v, cf in parsed.grad_lin[objno] if cf != 0.0]
    g0_cols = np.array([v for v, _ in g0], dtype=np.int64)
    g0_vals = np.array([cf for _, cf in g0])

    # ---- the groups' data and the segment maps of the summed outputs -----
    # cons: each row sums its offset, its groups' terms (group order) and
    # its linear entries; grad: each entry its objective terms' slots and
    # its linear coefficient
    con_targets = [np.arange(m)] + [g.rows for g in con_groups] + [lin_rows]
    ggroups = [g for g in obj_groups if g.grad_fn is not None]
    grad_targets = [g.var_ids.reshape(-1) for g in ggroups] + [g0_cols]
    arrays = dict(
        con_off=offsets[:m], lin_rows=lin_rows, lin_cols=lin_cols,
        lin_vals=lin_vals, g0_cols=g0_cols, g0_vals=g0_vals,
        con_table=segment_map(np.concatenate(con_targets), m),
        grad_table=segment_map(np.concatenate(grad_targets), n),
    )
    for i, g in enumerate(glist):
        arrays.update({f"g{i}_var_ids": g.var_ids, f"g{i}_consts": g.consts,
                       f"g{i}_signs": g.signs, f"g{i}_rows": g.rows,
                       f"g{i}_pa": g.pa, f"g{i}_pb": g.pb,
                       f"g{i}_hweight": g.hweight})
        g.index = i
    consts = DeviceConstants(**arrays)
    obj_off = float(offsets[-1])

    def _data(g, k, x):
        """(slot values, constants, signs) of group ``g`` at ``x``."""
        i = g.index
        zv = x[getattr(k, f"g{i}_var_ids")]
        zc = getattr(k, f"g{i}_consts").to(x.dtype)
        return zv, zc, getattr(k, f"g{i}_signs").to(x.dtype)

    # ---- evaluation closures ---------------------------------------------
    def _group_vals(g, k, x):
        zv, zc, signs = _data(g, k, x)
        return g.fn(zv, zc) * signs

    def cons(x):
        k = consts.on(x.device)
        parts = [k.con_off.to(x.dtype)]
        parts += [_group_vals(g, k, x) for g in con_groups]
        parts.append(k.lin_vals.to(x.dtype) * x[k.lin_cols])
        return segment_sum(torch.cat(parts), k.con_table)

    def obj(x):
        k = consts.on(x.device)
        val = x.new_zeros(()) + obj_off
        for g in obj_groups:
            val = val + torch.sum(_group_vals(g, k, x))
        if len(g0_cols):
            val = val + torch.dot(k.g0_vals.to(x.dtype), x[k.g0_cols])
        return val

    def _group_grads(g, k, x):
        zv, zc, signs = _data(g, k, x)
        return g.grad_fn(zv, zc) * signs[:, None]

    def grad(x):
        k = consts.on(x.device)
        parts = [_group_grads(g, k, x).reshape(-1) for g in ggroups]
        parts.append(k.g0_vals.to(x.dtype))
        return segment_sum(torch.cat(parts), k.grad_table)

    # ---- jacobian: nonlinear group entries + static linear entries -------
    jac_rows, jac_cols = [], []
    jgroups = []                        # groups with >=1 var slot on a constraint
    for g in con_groups:
        nv = g.var_ids.shape[1]
        if nv == 0:
            continue
        jgroups.append(g)
        jac_rows.append(np.repeat(g.rows, nv))
        jac_cols.append(g.var_ids.reshape(-1))
    jac_rows.append(lin_rows)
    jac_cols.append(lin_cols)
    jac_rows = np.concatenate(jac_rows)
    jac_cols = np.concatenate(jac_cols)

    def jac_coords(x):
        k = consts.on(x.device)
        parts = [_group_grads(g, k, x).reshape(-1) for g in jgroups]
        parts.append(k.lin_vals.to(x.dtype))
        return torch.cat(parts)

    # ---- hessian: per-group pair extraction -------------------------------
    hgroups = [g for g in glist if g.hess_fn is not None]
    hess_rows = (np.concatenate([g.hrows.reshape(-1) for g in hgroups])
                 if hgroups else np.zeros(0, np.int64))
    hess_cols = (np.concatenate([g.hcols.reshape(-1) for g in hgroups])
                 if hgroups else np.zeros(0, np.int64))

    def hess_coords(x, y, obj_weight):
        k = consts.on(x.device)
        parts = [x.new_zeros((0,))]
        for g in hgroups:
            i = g.index
            zv, zc, signs = _data(g, k, x)
            H = g.hess_fn(zv, zc)                    # (G, nv, nv)
            vals = H[:, getattr(k, f"g{i}_pa"), getattr(k, f"g{i}_pb")]
            if g.is_obj:
                w = x.new_zeros((len(g.rows),)) + obj_weight
            else:
                w = y[getattr(k, f"g{i}_rows")]
            vals = vals * (w * signs)[:, None]
            vals = vals * getattr(k, f"g{i}_hweight").to(x.dtype)
            parts.append(vals.reshape(-1))
        return torch.cat(parts)

    return SparseNLPModel(
        n=n, m=m, obj=obj, cons=cons, grad=grad, x0=parsed.x0,
        jac_rows=jac_rows, jac_cols=jac_cols, jac_coords=jac_coords,
        hess_rows=hess_rows, hess_cols=hess_cols, hess_coords=hess_coords,
        lvar=parsed.lvar, uvar=parsed.uvar, lcon=parsed.lcon,
        ucon=parsed.ucon, y0=parsed.y0,
        minimize=not maximize, name=parsed.path,
    )
