"""Problem reformulation layer — port of ``madnlp_tpu/ipm/problem.py``
(``Scaling``, ``Problem``, ``SparseProblem``, ``build_problem``).

Reformulates the user NLP

    min f(x)  s.t.  g_l <= g(x) <= g_u,  x_l <= x <= x_u

into the slack form used by the IPM

    min f(w)  s.t.  c(w) = 0,  xl <= w <= xu,   w = (x, s)

with ``c_i(w) = s_g(i) g_i(x) - s_i`` for inequality rows and
``c_i(w) = s_g(i) (g_i(x) - rhs_i)`` for equality rows, plus objective /
constraint / Jacobian scaling, the MakeParameter treatment of fixed
variables, equality relaxation and the min/max sign flip.  The index sets
are host-side numpy masks; :meth:`Problem.to` copies the ones the
evaluations need onto the solver's device once.

:class:`Problem` serves dense-callback models: the Jacobian is the dense
augmented ``(m, nw)`` matrix ``[J, -E]`` and the Hessian the dense
``(n, n)`` matrix.  :class:`SparseProblem` serves sparse-callback models:
value vectors over the static COO structures.

Every evaluation takes the model's parameters ``theta`` (ignored unless
the model is parametric).  The sparse evaluations also broadcast over a
leading lane axis: ``w (B, nw)`` with ``theta (B,)`` and a batch
:class:`Scaling` evaluates B scenarios at once.
"""

from __future__ import annotations

import dataclasses
import types
from typing import NamedTuple

import numpy as np
import torch

from ..models.model import to_tensor
from .kernels import as_col
from .quasi_newton import lowrank_zeros
from ..ops.segment import segment_map, segment_max, segment_sum
from ..utils.options import (
    EqualityTreatment,
    FixedVariableTreatment,
    HessianApproximation,
    MadNLPOptions,
)


class Scaling(NamedTuple):
    """Scaling factors computed once at ``initialize``: the objective scale
    is a host float, the constraint scale a float64 tensor ``(m,)``; for a
    batch, a ``(B,)`` tensor and a ``(B, m)`` tensor."""

    obj_scale: float
    con_scale: torch.Tensor


@dataclasses.dataclass
class Problem:
    """Static reformulated problem of a dense-callback model."""

    model: object
    opts: MadNLPOptions

    n: int       # original variables
    m: int       # constraints
    ns: int      # slacks (= #inequality rows)
    nw: int      # n + ns
    n_eq: int

    ineq_mask: np.ndarray       # (m,) bool — rows with a slack
    slack_sel: np.ndarray       # (ns,) int — constraint index of each slack
    lb_mask: np.ndarray         # (nw,) bool
    ub_mask: np.ndarray         # (nw,) bool
    llb_mask: np.ndarray        # (nw,) bool — lower-bounded only (x part only)
    uub_mask: np.ndarray        # (nw,) bool — upper-bounded only (x part only)
    eqrelax_mask: np.ndarray    # (nw,) bool — slacks of relaxed equality rows
    fixed_mask: np.ndarray      # (n,) bool (MakeParameter treatment)
    xl0: np.ndarray             # (nw,) reformulated lower bounds (pre-relax)
    xu0: np.ndarray             # (nw,)
    rhs: np.ndarray             # (m,) equality right-hand side (pre-scaling)
    sign: float                 # +1 minimize, -1 maximize
    xl_fixed: np.ndarray = None       # (n,) original lower bounds
    device: torch.device = None

    @property
    def nlb(self) -> int:
        return int(self.lb_mask.sum())

    @property
    def nub(self) -> int:
        return int(self.ub_mask.sum())

    @property
    def has_constraints(self) -> bool:
        return self.m > 0

    @property
    def is_sparse(self) -> bool:
        return False

    def _device_arrays(self) -> dict:
        fm = self.fixed_mask
        slack_e = np.zeros((self.m, self.ns))
        slack_e[self.slack_sel, np.arange(self.ns)] = -1.0
        return dict(
            slack_sel=self.slack_sel, rhs=self.rhs, fixed=fm,
            xl_fixed=self.xl_fixed, slack_e=slack_e,
            fixed_pair=fm[:, None] | fm[None, :],
            fixed_diag=np.where(fm, 1.0, 0.0),
        )

    def to(self, device) -> "Problem":
        """Materialise the masks and maps the evaluations use on ``device``."""
        self.device = torch.device(device)
        self.t = types.SimpleNamespace(**{
            k: to_tensor(v, self.device)
            for k, v in self._device_arrays().items()
        })
        return self

    def zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    # -- model calls: a parametric model takes theta last --------------------

    def _call(self, fn, *args, theta=None):
        return fn(*args, theta) if self.model.is_parametric else fn(*args)

    # -- evaluation pipeline ----------------------------------------------

    def x_of(self, w):
        return w[..., : self.n]

    def s_of(self, w):
        return w[..., self.n:]

    def scatter_slack(self, s):
        """(…, ns) slack values -> (…, m) with zeros on equality rows."""
        out = self.zeros(*s.shape[:-1], self.m)
        if self.ns:
            out[..., self.t.slack_sel] = s
        return out

    def gather_ineq(self, c):
        """(…, m) -> (…, ns) values on inequality rows."""
        return c[..., self.t.slack_sel]

    def eval_obj(self, scal: Scaling, w, theta=None):
        return self.sign * scal.obj_scale * self._call(
            self.model.obj, self.x_of(w), theta=theta)

    def eval_grad(self, scal: Scaling, w, theta=None):
        """(…, nw) gradient; slack part is zero."""
        x = self.x_of(w)
        g = as_col(scal.obj_scale) * self._call(self.model.grad, x, theta=theta)
        if self.fixed_mask.any():
            # MakeParameter: proximal pull to the fixed value
            g = torch.where(self.t.fixed, x - self.t.xl_fixed, g)
        g = self.sign * g
        return torch.cat([g, self.zeros(*g.shape[:-1], self.ns)], -1)

    def eval_cons(self, scal: Scaling, w, theta=None):
        """(…, m) internal constraints c(w)."""
        if self.m == 0:
            return self.zeros(*w.shape[:-1], 0)
        x, s = self.x_of(w), self.s_of(w)
        c = scal.con_scale * self._call(self.model.cons, x, theta=theta)
        c = c - self.scatter_slack(s)
        c = c - scal.con_scale * self.t.rhs
        return c

    def eval_jac(self, scal: Scaling, w, theta=None):
        """(m, nw) augmented Jacobian [s_g ∘ J(x), -E]."""
        J = scal.con_scale[:, None] * self._call(self.model.jac, self.x_of(w),
                                                 theta=theta)
        if self.fixed_mask.any():
            J = torch.where(self.t.fixed[None, :], 0.0, J)
        return torch.cat([J, self.t.slack_e], 1)

    def eval_jtprod_x(self, scal: Scaling, x, y, theta=None):
        """(n,) J(x)ᵀ y in the scaled space, by a vector-Jacobian product
        of the constraints (the quasi-Newton secant, nlpmodels.jl:790-800)."""
        if self.m == 0:
            return x.new_zeros(self.n)
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            (jt,) = torch.autograd.grad(
                self._call(self.model.cons, xx, theta=theta), xx,
                grad_outputs=y * scal.con_scale)
        jt = jt.detach()
        if self.fixed_mask.any():
            jt = torch.where(self.t.fixed, 0.0, jt)
        return jt

    def eval_lag_hess(self, scal: Scaling, w, y, theta=None,
                      is_resto: bool = False):
        """(n, n) Lagrangian Hessian in the scaled space."""
        obj_weight = (0.0 if is_resto else 1.0) * self.sign * scal.obj_scale
        H = self._call(self.model.lag_hess, self.x_of(w), y * scal.con_scale,
                       obj_weight, theta=theta)
        if self.fixed_mask.any():
            H = torch.where(self.t.fixed_pair, 0.0, H)
            H = H + torch.diag(self.t.fixed_diag)
        return H

    def compute_scaling(self, w0, theta=None) -> Scaling:
        """Row-max Jacobian scaling and gradient scaling
        (nlpmodels.jl:225-264)."""
        if not self.opts.nlp_scaling:
            return Scaling(1.0, self.zeros(self.m) + 1.0)
        max_g = self.opts.nlp_scaling_max_gradient
        if self.m > 0:
            unit = Scaling(1.0, self.zeros(self.m) + 1.0)
            J = self.eval_jac(unit, w0, theta)[:, : self.n]
            row_max = torch.clamp_min(J.abs().amax(1), 1.0)
            con_scale = torch.clamp_max(max_g / row_max, 1.0)
        else:
            con_scale = self.zeros(0)
        x = self.x_of(w0)
        gnorm = (float(self._call(self.model.grad, x, theta=theta).abs().max())
                 if self.n else 1.0)
        return Scaling(min(1.0, max_g / max(gnorm, 1e-300)), con_scale)

    def jac_template(self):
        return self.zeros(self.m, self.nw)

    def hess_template(self):
        return self.zeros(self.n, self.n)


@dataclasses.dataclass
class SparseProblem(Problem):
    """Static reformulated sparse-callback problem.  The Jacobian lives as
    ``(nnzj + ns,)`` scaled values over ``(jac_rows_aug, jac_cols_aug)``
    (slack entries are the trailing −1s), the Hessian as ``(nnzh,)`` values
    over the model's lower-triangular structure."""

    jac_rows_aug: np.ndarray = None   # (nnzj + ns,)
    jac_cols_aug: np.ndarray = None   # (nnzj + ns,) in [0, nw)
    hess_rows: np.ndarray = None
    hess_cols: np.ndarray = None

    @property
    def is_sparse(self) -> bool:
        return True

    @property
    def nnzj_aug(self) -> int:
        return len(self.jac_rows_aug)

    def _device_arrays(self) -> dict:
        mdl = self.model
        fm = self.fixed_mask
        hr, hc = mdl.hess_rows, mdl.hess_cols
        return dict(
            slack_sel=self.slack_sel,
            rhs=self.rhs,
            fixed=fm,
            xl_fixed=self.xl_fixed,
            jac_rows=mdl.jac_rows,
            jac_fixed=fm[mdl.jac_cols],
            col_table=segment_map(mdl.jac_cols, self.n),
            hess_fixed=fm[hr] | fm[hc],
            hess_unit=(hr == hc) & fm[hr],
            row_table=segment_map(mdl.jac_rows, self.m),
        )

    def eval_jac(self, scal: Scaling, w, theta=None):
        """(…, nnzj+ns) scaled jacobian values; slack entries are the
        trailing -1s."""
        vals = self._call(self.model.jac_coords, self.x_of(w), theta=theta)
        vals = vals * scal.con_scale[..., self.t.jac_rows]
        if self.fixed_mask.any():
            vals = torch.where(self.t.jac_fixed, 0.0, vals)
        return torch.cat([vals, vals.new_full(vals.shape[:-1] + (self.ns,),
                                              -1.0)], -1)

    def eval_jtprod_x(self, scal: Scaling, x, y, theta=None):
        """(n,) J(x)ᵀ y in the scaled space from the Jacobian's values (the
        quasi-Newton secant)."""
        vals = self._call(self.model.jac_coords, x, theta=theta)
        ys = y * scal.con_scale
        out = segment_sum(vals * ys[..., self.t.jac_rows], self.t.col_table)
        if self.fixed_mask.any():
            out = torch.where(self.t.fixed, 0.0, out)
        return out

    def eval_lag_hess(self, scal: Scaling, w, y, theta=None,
                      is_resto: bool = False):
        obj_weight = ((0.0 if is_resto else 1.0) * self.sign
                      * as_col(scal.obj_scale))
        vals = self._call(self.model.hess_coords, self.x_of(w),
                          y * scal.con_scale, obj_weight, theta=theta)
        if self.fixed_mask.any():
            vals = torch.where(self.t.hess_fixed, 0.0, vals)
            vals = torch.where(self.t.hess_unit, 1.0, vals)
        return vals

    def compute_scaling(self, w0, theta=None) -> Scaling:
        """Sparse row-max scaling (set_con_scale_sparse!,
        nlpmodels.jl:229-246); per lane for a batch ``w0 (B, nw)``."""
        lead = w0.shape[:-1]
        if not self.opts.nlp_scaling:
            ones = torch.ones(lead + (self.m,), dtype=torch.float64,
                              device=self.device)
            return Scaling(1.0 if not lead else ones.new_ones(lead), ones)
        max_g = self.opts.nlp_scaling_max_gradient
        x = self.x_of(w0)
        if self.m > 0:
            vals = self._call(self.model.jac_coords, x, theta=theta)
            row_max = segment_max(vals.abs(), self.t.row_table, 1.0)
            con_scale = torch.clamp_max(max_g / row_max, 1.0)
        else:
            con_scale = self.zeros(*lead, 0)
        if not lead:
            gnorm = (float(self._call(self.model.grad, x, theta=theta)
                           .abs().max()) if self.n else 1.0)
            return Scaling(min(1.0, max_g / max(gnorm, 1e-300)), con_scale)
        gnorm = (self._call(self.model.grad, x, theta=theta).abs().amax(-1)
                 .tolist() if self.n else [1.0] * lead[0])
        obj_scale = [min(1.0, max_g / max(g, 1e-300)) for g in gnorm]
        return Scaling(torch.tensor(obj_scale, dtype=torch.float64,
                                    device=self.device), con_scale)

    def jac_template(self):
        return self.zeros(self.nnzj_aug)

    def hess_template(self, lanes: int = None):
        """The Hessian's zero values; under compact L-BFGS the zero
        :class:`.quasi_newton.LowRankHessian`, whose diagonal the KKT
        system assembles and whose low-rank part it applies by SMW; with
        ``lanes``, one per lane."""
        if (self.opts.hessian_approximation
                == HessianApproximation.COMPACT_LBFGS):
            return lowrank_zeros(self.n,
                                 self.opts.quasi_newton_options.max_history,
                                 self.device, lanes)
        lead = () if lanes is None else (lanes,)
        return self.zeros(*lead, len(self.hess_rows))


def build_problem(model, opts: MadNLPOptions, device) -> Problem:
    """Host-side reformulation (the `create_callback` analogue,
    nlpmodels.jl:412-508), with the evaluation maps placed on ``device``."""
    n, m = model.n, model.m
    lvar = model.lvar.copy()
    uvar = model.uvar.copy()
    lcon = model.lcon.copy()
    ucon = model.ucon.copy()
    sign = 1.0 if model.minimize else -1.0

    # Fixed variables
    fixed_mask = np.zeros((n,), dtype=bool)
    xl_fixed = lvar.copy()
    if opts.fixed_variable_treatment == FixedVariableTreatment.MAKE_PARAMETER:
        fixed_mask = lvar == uvar
        if fixed_mask.any():
            # free the bounds, pin via grad/hess masking (nlpmodels.jl:580-590)
            lvar = np.where(fixed_mask, -np.inf, lvar)
            uvar = np.where(fixed_mask, np.inf, uvar)

    # Equality treatment
    if opts.equality_treatment == EqualityTreatment.RELAX:
        eq_rows = lcon == ucon
        ineq_mask = np.ones((m,), dtype=bool)
    else:
        eq_rows = np.zeros((m,), dtype=bool)
        ineq_mask = lcon < ucon

    slack_sel = np.nonzero(ineq_mask)[0].astype(np.int64)
    ns = len(slack_sel)
    nw = n + ns

    xl0 = np.concatenate([lvar, lcon[slack_sel]])
    xu0 = np.concatenate([uvar, ucon[slack_sel]])
    rhs = np.where(~ineq_mask, lcon, 0.0)

    llb = (lvar > -np.inf) & (uvar == np.inf)
    uub = (lvar == -np.inf) & (uvar < np.inf)
    fields = dict(
        model=model,
        opts=opts,
        n=n,
        m=m,
        ns=ns,
        nw=nw,
        n_eq=m - ns,
        ineq_mask=ineq_mask,
        slack_sel=slack_sel,
        lb_mask=xl0 > -np.inf,
        ub_mask=xu0 < np.inf,
        llb_mask=np.concatenate([llb, np.zeros((ns,), bool)]),
        uub_mask=np.concatenate([uub, np.zeros((ns,), bool)]),
        eqrelax_mask=np.concatenate([np.zeros((n,), bool), eq_rows[slack_sel]]),
        fixed_mask=fixed_mask,
        xl0=xl0,
        xu0=xu0,
        rhs=rhs,
        sign=sign,
        xl_fixed=xl_fixed,
    )
    if model.is_dense:
        return Problem(**fields).to(device)
    prob = SparseProblem(
        **fields,
        # the slack entries augment the jacobian structure so every
        # J-product is one uniform segment op
        jac_rows_aug=np.concatenate([model.jac_rows, slack_sel]),
        jac_cols_aug=np.concatenate(
            [model.jac_cols, n + np.arange(ns, dtype=np.int64)]),
        hess_rows=model.hess_rows,
        hess_cols=model.hess_cols,
    )
    return prob.to(device)
