"""The interior-point iteration — port of ``madnlp_tpu/ipm/step.py:Kernel``.

* ``initialize`` with least-squares duals (solver.jl:14-97), and
  ``reinitialize`` for a warm start (solver.jl:99-117);
* ``regular_step`` = one iteration of ``regular!`` (solver.jl:216-298):
  barrier update (monotone, or the adaptive rules of :mod:`.barrier`),
  δ regularization (inertia-based, inertia-free or inertia-ignoring),
  filter line search with second-order correction;
* ``restore_step`` = one iteration of soft restoration, ``restore!``
  (solver.jl:300-411);
* ``robust_step`` = one iteration of robust (ℓ1-penalty) restoration,
  ``robust!`` (solver.jl:413-545), with its own barrier, right-hand side
  and filter line search.

The three-phase state machine is ``state.status`` (REGULAR / RESTORE /
ROBUST), as in the JAX package.  Each ``lax.cond`` / ``while_loop`` of the
JAX package becomes Python control flow over device tensors: the host
reads the few scalars each decision needs (grouped into one read where
the JAX code computes them together) and updates the :class:`State` in
place.  The restoration phases factor through the same KKT system, and so
the same kernels, as the regular phase.

The Hessian is the model's exact one, or a quasi-Newton approximation
(:mod:`.quasi_newton`: BFGS, damped BFGS, compact L-BFGS) refreshed from
the secant pair at each evaluation point (``_refresh_hessian``).  Under an
adaptive barrier the state keeps the last factorization's KKT context
(``State.ctx``) for the next iteration's probing solves; under the
monotone rule it keeps none.
"""

from __future__ import annotations

import math

import torch

from ..kkt.vec import KKTVec
from ..utils.options import (
    BarrierUpdate,
    DualInitialization,
    HessianApproximation,
    InertiaCorrection,
    MadNLPOptions,
)
from ..utils.status import Status as S
from . import kernels as K
from .barrier import update_barrier_adaptive
from .problem import Problem
from .quasi_newton import (
    bfgs_update,
    init_hessian_dense,
    init_hessian_lowrank,
    lbfgs_update,
    lbfgs_update_compact,
)
from .state import State, state_zeros


def _all_finite(v) -> torch.Tensor:
    """Whether every entry of a tensor, or of each tensor of a tuple (a
    LowRankHessian), is finite (a device bool)."""
    if isinstance(v, tuple):
        return torch.stack([torch.isfinite(a).all() for a in v]).all()
    return torch.isfinite(torch.as_tensor(v)).all()


class Kernel:
    """Closes over the static problem/options; exposes the step functions."""

    def __init__(self, prob: Problem, opts: MadNLPOptions, kkt):
        self.prob = prob
        self.opts = opts
        self.kkt = kkt
        dev = prob.device

        def t(a):
            return torch.as_tensor(a, device=dev)

        self.lb = t(prob.lb_mask)
        self.ub = t(prob.ub_mask)
        self.llb = t(prob.llb_mask)
        self.uub = t(prob.uub_mask)
        # Auto -> Based if the linear solver exposes inertia, else Free
        # (IPM.jl:203-213)
        m = opts.inertia_correction_method
        if m == InertiaCorrection.AUTO:
            m = (InertiaCorrection.BASED if kkt.has_inertia()
                 else InertiaCorrection.FREE)
        self.inertia_method = m
        self.eps = float(torch.finfo(torch.float64).eps)
        # only the adaptive barriers' probing solves read the persisted
        # context (the previous factorization); the monotone rule keeps none
        self._persist_ctx = opts.barrier != BarrierUpdate.MONOTONE
        self.hess_approx = opts.hessian_approximation
        self.qn_mem = (opts.quasi_newton_options.max_history
                       if self.hess_approx == HessianApproximation.COMPACT_LBFGS
                       else 0)

    def persist_context(self, ctx):
        """The KKT context kept in ``State.ctx``: the factorization's under
        an adaptive barrier (its probing solves reuse the stale factor; the
        f64 operator band, read only by the same iteration's refinement, is
        dropped), None under the monotone rule."""
        if not self._persist_ctx:
            return None
        return ctx._replace(factor=ctx.factor._replace(opband=None))

    # ------------------------------------------------------------------
    # quasi-Newton / exact Hessian refresh (callbacks.jl:145-190)
    # ------------------------------------------------------------------

    def _refresh_hessian(self, st: State, is_resto: bool = False) -> None:
        """The Hessian at the current point: the model's (counted in
        ``hess_cnt``), or the quasi-Newton update from the secant pair
        (s, y) = (Δx, Δ∇ₓL) since the last refresh; before the first
        gradient pair exists (grad_cnt < 2), the Gilbert–Lemaréchal
        start."""
        p, o = self.prob, self.opts
        if self.hess_approx == HessianApproximation.EXACT:
            st.hess = p.eval_lag_hess(st.scal, st.x, st.y, st.theta,
                                      is_resto=is_resto)
            st.hess_cnt += 1
            return
        n = p.n
        qn = st.qn
        if st.grad_cnt >= 2:
            sk = st.x[:n] - qn.last_x
            yk = st.f[:n] - qn.last_g
            if p.m > 0:
                yk = yk + st.jacl[:n]
                yk = yk - p.eval_jtprod_x(st.scal, qn.last_x, st.y, st.theta)
            if self.hess_approx == HessianApproximation.COMPACT_LBFGS:
                update = lbfgs_update_compact if p.is_sparse else lbfgs_update
                st.hess, qn = update(st.hess, qn, sk, yk,
                                     o.quasi_newton_options)
            else:
                st.hess, qn = bfgs_update(
                    st.hess, qn, sk, yk,
                    damped=self.hess_approx == HessianApproximation.DAMPED_BFGS)
        else:
            st.hess = self._init_hessian(st.hess, st.f[:n], st.obj_val)
        st.qn = qn._replace(last_x=st.x[:n], last_g=st.f[:n])

    def _init_hessian(self, hess, g0, f0: float):
        """The Gilbert–Lemaréchal start (quasi_newton.jl:194-206): the
        low-rank form's diagonal over a sparse KKT system, a scaled
        identity over a dense one."""
        p, qo = self.prob, self.opts.quasi_newton_options
        if p.is_sparse:
            return init_hessian_lowrank(hess, g0, f0, qo.init_value)
        return init_hessian_dense(p.n, g0, f0, qo.init_value)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def slacks(self, x, xl, xu):
        return K.slacks(x, xl, xu, self.lb, self.ub)

    def _where_bound(self, mask):
        return torch.where(mask, 1.0, 0.0).to(torch.float64)

    def _sd_sc(self, st: State):
        p, o = self.prob, self.opts
        sd = K.get_sd(st.y, st.zl, st.zu, self.lb, self.ub, p.m, p.nlb, p.nub,
                      o.s_max)
        sc = K.get_sc(st.zl, st.zu, self.lb, self.ub, p.nlb, p.nub, o.s_max)
        return sd, sc

    def _residuals(self, st: State, sd, sc):
        """(inf_pr, inf_du, inf_compl) of the original problem, on the
        device."""
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        return (K.get_inf_pr(st.c),
                K.get_inf_du(st.f, st.zl, st.zu, st.jacl, sd),
                K.get_inf_compl(dl, du_, st.zl, st.zu, self.lb, self.ub, 0.0,
                                sc))

    @staticmethod
    def _log_row(st: State, mu, inf_pr, inf_du, inf_compl, is_resto):
        return [float(st.k), st.obj_val, inf_pr, inf_du, inf_compl, mu,
                st.del_w, st.alpha, float(st.last_ir), float(st.l_cnt),
                float(st.ftype), 1.0 if is_resto else 0.0]

    def _x0(self, theta):
        """The model's initial primal point, fixed variables at their
        value."""
        p = self.prob
        if getattr(p.model, "x0_fn", None) is not None:
            x0 = p.model.x0_fn(theta)
        else:
            x0 = torch.as_tensor(p.model.x0, device=p.device)
        if p.fixed_mask.any():
            x0 = torch.where(p.t.fixed, p.t.xl_fixed, x0)
        return x0

    def eval_obj(self, st, w):
        return self.prob.eval_obj(st.scal, w, st.theta)

    def eval_cons(self, st, w):
        return self.prob.eval_cons(st.scal, w, st.theta)

    # ------------------------------------------------------------------
    # initialization (solver.jl:14-77 + nlpmodels.jl:593-636)
    # ------------------------------------------------------------------

    def zero_state(self, theta=None) -> State:
        """A zero state of this problem's shapes, holding ``theta`` (the
        template a checkpoint loads into)."""
        p = self.prob
        st = state_zeros(p.nw, p.m, p.jac_template(), p.hess_template(),
                         self.opts.filter_capacity, p.device, n=p.n,
                         qn_mem=self.qn_mem)
        st.theta = theta
        if self._persist_ctx:
            st.ctx = self.kkt.zero_context()
        return st

    def initialize(self, theta=None) -> State:
        """``theta``: the model's parameters (a tensor; parametric models)."""
        p, o = self.prob, self.opts
        dev = p.device
        st = self.zero_state()
        lb, ub = self.lb, self.ub

        xl = torch.as_tensor(p.xl0, device=dev)
        xu = torch.as_tensor(p.xu0, device=dev)
        # relaxed-equality slacks get one extra relaxation (nlpmodels.jl:576)
        if p.eqrelax_mask.any():
            er = torch.as_tensor(p.eqrelax_mask, device=dev)
            xl2, xu2 = K.set_initial_bounds(xl, xu, lb, ub, o.bound_relax_factor)
            xl = torch.where(er, xl2, xl)
            xu = torch.where(er, xu2, xu)
        xl, xu = K.set_initial_bounds(xl, xu, lb, ub, o.bound_relax_factor)

        x0 = self._x0(theta)
        n = p.n
        xv = K.initialize_variables(x0, xl[:n], xu[:n], lb[:n], ub[:n],
                                    o.bound_push, o.bound_fac)
        # slack init from unscaled constraint values (nlpmodels.jl:626-636)
        g0 = p._call(p.model.cons, xv, theta=theta) if p.m else p.zeros(0)
        s0 = K.initialize_variables(p.gather_ineq(g0), xl[n:], xu[n:],
                                    lb[n:], ub[n:], o.bound_push, o.bound_fac)
        w0 = torch.cat([xv, s0])
        zl = self._where_bound(lb)
        zu = self._where_bound(ub)
        y0 = torch.as_tensor(p.model.y0, device=dev) * p.sign

        # scaling (computed at the pushed initial point, nlpmodels.jl:693-765)
        scal = p.compute_scaling(w0, theta)
        if p.m:
            y0 = y0 / torch.clamp_min(scal.con_scale, 1e-300)
        cs_slk = p.gather_ineq(scal.con_scale)
        w0[n:] = w0[n:] * cs_slk
        xl[n:] = xl[n:] * cs_slk
        xu[n:] = xu[n:] * cs_slk

        st.x, st.y, st.zl, st.zu, st.xl, st.xu, st.scal = w0, y0, zl, zu, xl, xu, scal
        st.theta = theta
        st.mu = o.barrier_options.mu_init
        st.tau = max(o.tau_min, 1.0 - o.barrier_options.mu_init)

        # first evaluations
        st.jac = p.eval_jac(scal, w0, theta)
        st.f = p.eval_grad(scal, w0, theta)
        obj = p.eval_obj(scal, w0, theta)
        st.c = p.eval_cons(scal, w0, theta)
        st.jacl = self.kkt.jtprod(st.jac, y0)
        st.obj_cnt = st.grad_cnt = st.con_cnt = st.jac_cnt = 1
        if self.hess_approx == HessianApproximation.EXACT:
            st.hess = p.eval_lag_hess(scal, w0, y0, theta)
            st.hess_cnt = 1
        else:
            st.hess = self._init_hessian(st.hess, st.f[:n],
                                         float(obj.to(torch.float64)))
            st.qn = st.qn._replace(last_x=w0[:n], last_g=st.f[:n])

        if (not o.dual_initialized
                and o.dual_initialization_method == DualInitialization.LEAST_SQUARES
                and p.m > 0):
            st.y, ls_ctx = self._least_squares_duals(st)
            st.ctx = self.persist_context(ls_ctx)
            st.jacl = self.kkt.jtprod(st.jac, st.y)

        finite = torch.stack([
            _all_finite(v) for v in (st.hess, st.jac, st.c, st.f, obj)
        ]).tolist()
        theta, st.obj_val = torch.stack([K.get_theta(st.c),
                                         obj.to(torch.float64)]).tolist()
        st.theta_max = 1e4 * max(1.0, theta)
        st.theta_min = 1e-4 * max(1.0, theta)
        st.filter = K.filter_reset(st.filter, st.theta_max)
        # NaN/Inf guards on the first evaluations (callbacks.jl:13-15);
        # the last failing check wins, as in the JAX package
        status = S.REGULAR
        for ok, code in zip(finite, (
                S.INVALID_NUMBER_HESSIAN_LAGRANGIAN, S.INVALID_NUMBER_JACOBIAN,
                S.INVALID_NUMBER_CONSTRAINTS, S.INVALID_NUMBER_GRADIENT,
                S.INVALID_NUMBER_OBJECTIVE)):
            if not ok:
                status = code
        st.status = int(status)
        return st

    def reinitialize(self, st: State, theta=None) -> State:
        """Warm start / re-solve (reference ``reinitialize!``,
        solver.jl:99-117): reset the primal variables to x0 keeping the
        slacks, the duals, the bounds and the scaling, re-evaluate at the
        new parameters ``theta``, reset the filter and the barrier.  The
        returned state carries ``theta``: the JAX package evaluates the
        new point at ``theta`` but keeps the old parameters in its state,
        so its later iterations re-solve the old instance; the port does
        not copy that."""
        p, o = self.prob, self.opts
        x = st.x.clone()
        x[: p.n] = self._x0(theta)
        st.x, st.theta = x, theta
        obj = p.eval_obj(st.scal, x, theta)
        st.f = p.eval_grad(st.scal, x, theta)
        st.c = p.eval_cons(st.scal, x, theta)
        st.jac = p.eval_jac(st.scal, x, theta)
        st.jacl = self.kkt.jtprod(st.jac, st.y)
        st.obj_cnt += 1
        st.grad_cnt += 1
        st.con_cnt += 1
        st.jac_cnt += 1
        if self.hess_approx == HessianApproximation.EXACT:
            st.hess = p.eval_lag_hess(st.scal, x, st.y, theta)
            st.hess_cnt += 1
        theta_c, st.obj_val = torch.stack([K.get_theta(st.c),
                                           obj.to(torch.float64)]).tolist()
        st.theta_max = 1e4 * max(1.0, theta_c)
        st.theta_min = 1e-4 * max(1.0, theta_c)
        mu0 = o.barrier_options.mu_init
        st.mu, st.tau = mu0, max(o.tau_min, 1.0 - mu0)
        st.filter = K.filter_reset(st.filter, st.theta_max)
        st.status = int(S.REGULAR)
        st.k = st.acceptable_cnt = st.restoration_fail_count = 0
        st.unsuccessful_iterate = 0
        st.del_w = st.del_w_last = 0.0
        st.rr_init_needed = False
        return st

    def _least_squares_duals(self, st: State):
        """Solve [I Aᵀ; A 0] with rhs (-∇f + zl - zu, 0) and take the dual
        part, dropped if ‖·‖∞ > constr_mult_init_max (solver.jl:86-97).
        This factorization is not counted in ``factorization_cnt``.
        Returns the duals and the factorization's context."""
        p = self.prob
        ones = p.zeros(p.nw) + 1.0
        ctx = self.kkt.build_and_factorize(
            hess=p.hess_template(), jac=st.jac, reg=ones,
            du_diag=p.zeros(p.m), dl=ones, du_=ones,
            zl=p.zeros(p.nw), zu=p.zeros(p.nw),
        )
        rhs = KKTVec(xp=-st.f + st.zl - st.zu, y=p.zeros(p.m),
                     zl=p.zeros(p.nw), zu=p.zeros(p.nw))
        d, ok, _ = self.kkt.solve_refine(ctx, rhs)
        too_big = float(d.y.abs().max()) > self.opts.constr_mult_init_max
        return (d.y if ok and not too_big else p.zeros(p.m)), ctx

    # ------------------------------------------------------------------
    # barrier update (monotone, barrier.jl:12-34; adaptive: barrier.py)
    # ------------------------------------------------------------------

    def update_barrier(self, st: State, sc):
        b = self.opts.barrier
        if b == BarrierUpdate.MONOTONE:
            return self.update_barrier_monotone(st, sc)
        return update_barrier_adaptive(
            self, st, sc,
            "quality_function" if b == BarrierUpdate.QUALITY_FUNCTION
            else "loqo")

    def update_barrier_monotone(self, st: State, sc):
        o = self.opts
        bo = o.barrier_options
        dl, du_ = self.slacks(st.x, st.xl, st.xu)

        def compl_at(mu):
            return float(K.get_inf_compl(dl, du_, st.zl, st.zu, self.lb,
                                         self.ub, mu, sc))

        mu, tau, filt = st.mu, st.tau, st.filter
        icm = compl_at(mu)
        mu_min = o.mu_min
        while (mu > max(mu_min, o.tol / 10)
               and max(st.inf_pr, st.inf_du, icm) <= o.barrier_tol_factor * mu):
            mu_new = K.get_mu(mu, mu_min, bo.mu_linear_decrease_factor,
                              bo.mu_superlinear_decrease_power, o.tol)
            # N.B. the reference recomputes compl and tau with the *old* mu
            # before assigning mu_new (barrier.jl:20-31)
            icm = compl_at(mu)
            tau = K.get_tau(mu, o.tau_min)
            filt = K.filter_reset(filt, st.theta_max)
            mu = mu_new
        st.mu, st.tau, st.inf_compl_mu, st.filter = mu, tau, icm, filt

    # ------------------------------------------------------------------
    # Newton system assembly + inertia correction (solver.jl:611-783)
    # ------------------------------------------------------------------

    def _aug_rhs(self, st: State, c, mu) -> KKTVec:
        """set_aug_rhs! (kernels.jl:113-130) + κ_d damping."""
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        px = -st.f + st.zl - st.zu - st.jacl
        px = K.dual_inf_perturbation(px, self.llb, self.uub, mu,
                                     self.opts.kappa_d)
        return KKTVec(
            xp=px,
            y=-c,
            zl=torch.where(self.lb, mu - dl * st.zl, 0.0),
            zu=torch.where(self.ub, du_ * st.zu - mu, 0.0),
        )

    def _factorize(self, st: State, del_w, del_c, rr: bool = False):
        """build_kkt! + factorize! with total regularization δw, δc; with
        ``rr``, the robust-restoration system: the proximal weight ζ·D_R²
        on the primal diagonal and -p/z_p - n/z_n on the dual one."""
        o, p = self.opts, self.prob
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        if rr:
            R = st.RR
            reg = o.default_primal_regularization + R.zeta * R.D_R**2 + del_w
            du_diag = (-o.default_dual_regularization - R.pp / R.zp
                       - R.nn / R.zn - del_c)
        else:
            reg = p.zeros(p.nw) + o.default_primal_regularization + del_w
            du_diag = p.zeros(p.m) - o.default_dual_regularization - del_c
        return self.kkt.build_and_factorize(
            st.hess, st.jac, reg, du_diag, dl, du_, st.zl, st.zu, rr=rr)

    def _next_del_w(self, n_trial, del_w, del_w_last):
        """The δ_w escalation ladder (solver.jl:639-649)."""
        o = self.opts
        if n_trial == 0:
            if del_w_last == 0.0:
                return o.first_hessian_perturbation
            return max(o.min_hessian_perturbation, o.perturb_dec_fact * del_w_last)
        return del_w * (o.perturb_inc_fact_first if del_w_last == 0.0
                        else o.perturb_inc_fact)

    def inertia_correction(self, st: State, p_rhs: KKTVec, rr: bool = False):
        """The δ regularization ladder (solver.jl:611-737) under the
        resolved inertia strategy.  Returns (ctx, d, success); counters and
        δs land in ``st``.  ``rr``: the robust-restoration system, whose
        solves keep the exact refinement tolerance and whose δ_c follows
        μ_R."""
        o = self.opts
        if self.inertia_method == InertiaCorrection.BASED:
            def attempt(del_w, del_c):
                return self._attempt_based(st, p_rhs, rr, del_w, del_c)
        elif self.inertia_method == InertiaCorrection.IGNORE:
            def attempt(del_w, del_c):
                return self._attempt_ignore(st, p_rhs, rr, del_w, del_c)
        else:
            g, p0 = self._free_test_data(st, st.RR.mu_R if rr else st.mu)

            def attempt(del_w, del_c):
                return self._attempt_free(st, p_rhs, rr, del_w, del_c, g, p0)
        mu = st.RR.mu_R if rr else st.mu
        ctx, d, ok, nzero = attempt(0.0, 0.0)
        n_trial, del_w, del_c, fail = 0, 0.0, 0.0, False
        while not ok and not fail:
            del_w = self._next_del_w(n_trial, del_w, st.del_w_last)
            # δ_c on a rank-deficient Jacobian (zero pivots); the strategies
            # that see no inertia (nzero None) take it on every retry
            del_c = (o.jacobian_regularization_value
                     * mu**o.jacobian_regularization_exponent
                     if nzero != 0 else 0.0)
            n_trial += 1
            if del_w > o.max_hessian_perturbation:
                fail = True      # keep the previous payloads (unused)
            else:
                ctx, d, ok, nzero = attempt(del_w, del_c)
        st.del_w = del_w
        st.del_c = del_c
        if del_w != 0.0:
            st.del_w_last = del_w
        return ctx, d, ok and not fail

    def _ladder_solve(self, st: State, ctx, rhs: KKTVec, rr: bool):
        """A refined solve of the ladder, (d, solved, sweeps).  Restoration
        solves rank-deficient geometry where step accuracy decides
        feasibility recovery, so its solves keep the exact tolerance."""
        return self.kkt.solve_refine(ctx, rhs, mu=None if rr else st.mu)

    def _count(self, st: State, iters: int) -> None:
        st.factorization_cnt += 1
        st.backsolve_cnt += iters
        st.last_ir = iters

    def _attempt_based(self, st, p_rhs, rr, del_w, del_c):
        """Factor and solve; success needs the inertia (num_pos == nw, no
        zero pivot) and the solve.  The solve runs, and is counted,
        whatever the inertia, as in the JAX package."""
        ctx = self._factorize(st, del_w, del_c, rr=rr)
        pos, nzero, neg = self.kkt.inertia(ctx)
        d, solved, iters = self._ladder_solve(st, ctx, p_rhs, rr)
        self._count(st, iters)
        return (ctx, d, self.kkt.is_inertia_correct(pos, nzero, neg)
                and solved, nzero)

    def _attempt_ignore(self, st, p_rhs, rr, del_w, del_c):
        """Factor and solve; success is the solve's alone."""
        ctx = self._factorize(st, del_w, del_c, rr=rr)
        d, solved, iters = self._ladder_solve(st, ctx, p_rhs, rr)
        self._count(st, iters)
        return ctx, d, solved, None

    def _free_test_data(self, st: State, mu):
        """The inertia-free test's gradient g_ifr (kernels.jl:242-248) and
        the right-hand side (0, -c, 0, 0) of its normal step; ``mu`` is μ
        (μ_R in robust restoration): a host float, or a ``(B,)`` tensor in
        a batch."""
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        mu = K.as_col(mu)
        g = (st.f - torch.where(self.lb, mu / dl, 0.0)
             + torch.where(self.ub, mu / du_, 0.0) + st.jacl)
        zero = torch.zeros_like(st.x)
        return g, KKTVec(xp=zero, y=-st.c, zl=zero, zu=zero)

    def _attempt_free(self, st, p_rhs, rr, del_w, del_c, g, p0):
        """Factor, solve the normal step d₀ and the full step d, and test
        the curvature of t = d - d₀ (solver.jl:672-737, curv_test
        :785-788): tᵀWt + max(0, tᵀW d₀ - gᵀd₀) - tol·tᵀt ≥ 0, with
        W = (∇²L + Σ) through ``mul_hess_blk``."""
        ctx = self._factorize(st, del_w, del_c, rr=rr)
        d0, ok0, it0 = self._ladder_solve(st, ctx, p0, rr)
        d, ok1, it1 = self._ladder_solve(st, ctx, p_rhs, rr)
        self._count(st, it0 + it1)
        t = d.xp - d0.xp
        wx = self.kkt.mul_hess_blk(ctx, t)
        tWt, tWd0, gd0, tt = torch.stack([
            torch.dot(wx, t), torch.dot(wx, d0.xp), torch.dot(g, d0.xp),
            torch.dot(t, t)]).tolist()
        curv_ok = (tWt + max(tWd0 - gd0, 0.0)
                   - self.opts.inertia_free_tol * tt) >= 0.0
        return ctx, d, ok0 and ok1 and curv_ok, None

    # ------------------------------------------------------------------
    # second-order correction (solver.jl:547-608)
    # ------------------------------------------------------------------

    def second_order_correction(
        self, st: State, ctx, d: KKTVec, alpha_max, theta, varphi,
        theta_trial0, varphi_d, switching_condition,
    ):
        """Returns (accepted, alpha_soc, ftype, x_trial, obj_trial, c_trial)."""
        o, p = self.opts, self.prob
        wy = st.c_trial + alpha_max * st.c
        theta_soc_old = theta_trial0
        result = (False, 0.0, K.FTYPE_NONE, st.x_trial, st.obj_val_trial,
                  st.c_trial)
        for pcnt in range(1, max(o.max_soc, 1) + 1):
            rhs = self._aug_rhs(st, wy, st.mu)
            w1, _, iters = self.kkt.solve_refine(ctx, rhs, mu=st.mu)
            st.backsolve_cnt += iters
            st.last_ir = iters
            a_soc = float(K.get_alpha_max(st.x, st.xl, st.xu, w1.xp, st.tau,
                                          self.lb, self.ub))
            x_soc = st.x + a_soc * w1.xp
            c_soc = self.eval_cons(st, x_soc)
            obj_soc = self.eval_obj(st, x_soc)
            st.con_cnt += 1
            st.obj_cnt += 1
            dl_t, du_t = self.slacks(x_soc, st.xl, st.xu)
            obj_soc, theta_soc, varphi_soc = torch.stack([
                obj_soc.to(torch.float64), K.get_theta(c_soc),
                K.get_varphi(obj_soc, dl_t, du_t, self.lb, self.ub, st.mu),
            ]).tolist()

            filter_ok = K.is_filter_acceptable(st.filter, theta_soc, varphi_soc)
            case1 = (theta <= st.theta_min) and switching_condition
            if case1:
                # N.B. st.alpha is the previous iteration's step here, as
                # in the JAX package (the line search sets it afterwards)
                accept_now = filter_ok and K.is_armijo(
                    varphi_soc, varphi, o.eta_phi, st.alpha, varphi_d)
            else:
                accept_now = filter_ok and K.is_sufficient_progress(
                    theta_soc, theta, o.gamma_theta, varphi_soc, varphi,
                    o.gamma_phi, p.has_constraints, self.eps)
            if accept_now:
                ftype = K.FTYPE_SOC_F if case1 else K.FTYPE_SOC_H
                return True, a_soc, ftype, x_soc, obj_soc, c_soc
            if (not filter_ok) or theta_soc > o.kappa_soc * theta_soc_old:
                break
            wy = w1.y
            theta_soc_old = theta_soc
        return result

    # ------------------------------------------------------------------
    # filter line search (line_search.jl:6-123)
    # ------------------------------------------------------------------

    def filter_line_search(self, st: State, ctx, d: KKTVec):
        """Sets the trial point, alpha, ftype and filter in ``st`` and
        ``status`` to one of LINESEARCH_SUCCEEDED / RESTORE /
        REGULAR (second chance) / SOLVED_TO_ACCEPTABLE_LEVEL /
        SEARCH_DIRECTION_BECOMES_TOO_SMALL."""
        o, p = self.opts, self.prob
        eps = self.eps
        lb, ub = self.lb, self.ub
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (theta, varphi, varphi_d, alpha_max, alpha_z, rel_norm,
         dnorm) = torch.stack([
            K.get_theta(st.c),
            K.get_varphi(st.obj_val, dl, du_, lb, ub, st.mu),
            K.get_varphi_d(st.f, dl, du_, lb, ub, d.xp, st.mu),
            K.get_alpha_max(st.x, st.xl, st.xu, d.xp, st.tau, lb, ub),
            K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, st.tau, lb, ub),
            K.get_rel_search_norm(st.x, d.xp),
            d.xp.abs().max(),
        ]).tolist()
        alpha_min = K.get_alpha_min(
            theta, varphi_d, st.theta_min, o.gamma_theta, o.gamma_phi,
            o.alpha_min_frac, o.delta, o.s_theta, o.s_phi,
        )
        small_search_norm = rel_norm < 10 * eps
        # (theta = 2.0 here, as in the JAX package)
        switching = K.is_switching(varphi_d, alpha_max, o.s_phi, o.delta, 2.0,
                                   o.s_theta)

        st.l_cnt = 1
        alpha = alpha_max
        while True:
            x_t = st.x + alpha * d.xp
            obj_t = self.eval_obj(st, x_t)
            c_t = self.eval_cons(st, x_t)
            st.obj_cnt += 1
            st.con_cnt += 1
            dl_t, du_t = self.slacks(x_t, st.xl, st.xu)
            obj_t_f, th_t, ph_t = torch.stack([
                obj_t.to(torch.float64), K.get_theta(c_t),
                K.get_varphi(obj_t, dl_t, du_t, lb, ub, st.mu),
            ]).tolist()
            st.x_trial, st.obj_val_trial, st.c_trial = x_t, obj_t_f, c_t
            armijo = K.is_armijo(ph_t, varphi, o.eta_phi, alpha, varphi_d)
            ftype = K.get_ftype(
                st.filter, theta, th_t, varphi, ph_t, switching, armijo,
                st.theta_min, o.obj_max_inc, o.gamma_theta, o.gamma_phi,
                p.has_constraints, eps,
            )
            accept_f = ftype in (K.FTYPE_F, K.FTYPE_H)
            if accept_f:
                st.ftype = ftype

            # SOC attempt: first backtrack only, theta increased
            soc_accepted = False
            if (not accept_f and not small_search_norm and st.l_cnt == 1
                    and th_t >= theta):
                (soc_accepted, alpha_soc, ft, x_s, obj_s,
                 c_s) = self.second_order_correction(
                    st, ctx, d, alpha_max, theta, varphi, th_t, varphi_d,
                    switching)
                if soc_accepted:
                    st.x_trial, st.obj_val_trial, st.c_trial = x_s, obj_s, c_s
                    st.ftype = ft

            if accept_f or small_search_norm or soc_accepted:
                alpha = alpha_soc if soc_accepted else alpha
                code = 0
                break
            # rejection path (line_search.jl:79-97)
            alpha_next = alpha / 2.0
            alpha = alpha_next
            if alpha_next < alpha_min:
                st.k += 1
                code = S.RESTORE
                break
            if alpha_next * dnorm < eps * 10:
                rfc = st.restoration_fail_count + 1
                st.restoration_fail_count = rfc
                if rfc >= 4:
                    code = (S.SOLVED_TO_ACCEPTABLE_LEVEL if st.acceptable_cnt > 0
                            else S.SEARCH_DIRECTION_BECOMES_TOO_SMALL)
                else:
                    # second chance: reset the duals and the filter
                    st.y = torch.zeros_like(st.y)
                    st.zl = self._where_bound(lb)
                    st.zu = self._where_bound(ub)
                    st.filter = K.filter_reset(st.filter, st.theta_max)
                    st.k += 1
                    code = S.REGULAR
                break
            st.l_cnt += 1
        st.alpha, st.alpha_z = alpha, alpha_z

        if code != 0:
            st.status = int(code)
            return st
        # filter-restart heuristic (line_search.jl:103-115): count
        # iterations that needed backtracking (l_cnt > 1 at acceptance)
        if st.l_cnt > 1:
            cnt = st.unsuccessful_iterate + 1
            if cnt >= 4:
                tm = st.theta_max / 10.0
                if tm > th_t:
                    st.theta_max = tm
                    st.filter = K.filter_reset(st.filter, tm)
                st.unsuccessful_iterate = 0
            else:
                st.unsuccessful_iterate = cnt
        else:
            st.unsuccessful_iterate = 0
        # augment filter (line_search.jl:117-120)
        if (not switching) or (not armijo):
            st.filter = K.filter_augment(st.filter, th_t, ph_t, o.gamma_theta)
        st.status = int(S.LINESEARCH_SUCCEEDED)
        return st

    # ------------------------------------------------------------------
    # regular! — one iteration (solver.jl:216-298)
    # ------------------------------------------------------------------

    def regular_step(self, st: State) -> State:
        o, p = self.opts, self.prob

        # Jacobian refresh (skipped at k == 0: evaluated in initialize)
        if not o.jacobian_constant and st.k > 0:
            st.jac = p.eval_jac(st.scal, st.x, st.theta)
            st.jac_cnt += 1
        st.jacl = self.kkt.jtprod(st.jac, st.y)

        sd, sc = self._sd_sc(st)
        sc, inf_pr, inf_du, inf_compl = torch.stack([
            sc, *self._residuals(st, sd, sc)]).tolist()
        st.inf_pr, st.inf_du, st.inf_compl = inf_pr, inf_du, inf_compl
        st.log_row = self._log_row(st, st.mu, inf_pr, inf_du, inf_compl, False)

        # termination (solver.jl:239-246)
        inf_total = max(inf_pr, inf_du, inf_compl)
        status = S.REGULAR
        acceptable = inf_total <= o.acceptable_tol
        if acceptable and st.acceptable_cnt >= o.acceptable_iter:
            status = S.SOLVED_TO_ACCEPTABLE_LEVEL
        if inf_total >= o.diverging_iterates_tol:
            status = S.DIVERGING_ITERATES
        if st.k >= o.max_iter:
            status = S.MAXIMUM_ITERATIONS_EXCEEDED
        if inf_total <= o.tol:
            status = S.SOLVE_SUCCEEDED
        st.acceptable_cnt = st.acceptable_cnt + 1 if acceptable else 0
        st.status = int(status)
        if status != S.REGULAR:
            return st

        # Hessian refresh
        if not o.hessian_constant and st.k > 0:
            self._refresh_hessian(st)
        # (an adaptive rule's probing solves reuse st.ctx, the stale factor)
        self.update_barrier(st, sc)
        p_rhs = self._aug_rhs(st, st.c, st.mu)
        ctx, d, ok = self.inertia_correction(st, p_rhs)
        st.d, st.p = d, p_rhs
        st.ctx = self.persist_context(ctx)
        if not ok:
            # solver.jl:646-649: k += 1 before switching to robust
            # restoration
            st.status = int(S.ROBUST)
            st.k += 1
            st.rr_init_needed = True
            return st

        self.filter_line_search(st, ctx, d)
        if st.status == S.RESTORE:
            # stash the backups and set soft restoration up
            # (solver.jl:300-322)
            dl, du_ = self.slacks(st.x, st.xl, st.xu)
            st.soft_F = float(K.get_F(st.c, st.f, st.zl, st.zu, st.jacl, dl,
                                      du_, self.lb, self.ub, st.mu))
            st.del_w = 0.0
            st.backup_x, st.backup_y, st.backup_c = st.x, st.y, st.c
            st.alpha_z = 0.0
            st.ftype = K.FTYPE_RESTORE
            return st
        if st.status != S.LINESEARCH_SUCCEEDED:
            return st      # second chance (REGULAR) or an exit
        x = st.x_trial
        y = st.y + st.alpha * d.y
        zl = st.zl + st.alpha_z * d.zl
        zu = st.zu + st.alpha_z * d.zu
        xl, xu = K.adjust_boundary(x, st.xl, st.xu, self.lb, self.ub, st.mu)
        dl, du_ = K.slacks(x, xl, xu, self.lb, self.ub)
        st.zl = K.reset_bound_dual(zl, dl, self.lb, st.mu, o.kappa_sigma)
        st.zu = K.reset_bound_dual(zu, du_, self.ub, st.mu, o.kappa_sigma)
        st.x, st.y, st.xl, st.xu = x, y, xl, xu
        st.c, st.obj_val = st.c_trial, st.obj_val_trial
        st.f = p.eval_grad(st.scal, x, st.theta)
        st.grad_cnt += 1
        st.k += 1
        st.status = int(S.REGULAR)
        return st

    # ------------------------------------------------------------------
    # restore! — soft restoration, one iteration (solver.jl:300-411)
    # ------------------------------------------------------------------

    def restore_step(self, st: State) -> State:
        o, p = self.opts, self.prob
        lb, ub = self.lb, self.ub
        d = st.d
        alpha_max, alpha_z = torch.stack([
            K.get_alpha_max(st.x, st.xl, st.xu, d.xp, st.tau, lb, ub),
            K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, st.tau, lb, ub),
        ]).tolist()
        alpha = min(alpha_max, alpha_z)
        x = st.x + alpha * d.xp
        y = st.y + alpha * d.y
        zl = st.zl + alpha * d.zl
        zu = st.zu + alpha * d.zu
        c = self.eval_cons(st, x)
        f = p.eval_grad(st.scal, x, st.theta)
        obj = self.eval_obj(st, x)
        if not o.jacobian_constant:
            st.jac = p.eval_jac(st.scal, x, st.theta)
            st.jac_cnt += 1
        jacl = self.kkt.jtprod(st.jac, y)
        st.con_cnt += 1
        st.grad_cnt += 1
        st.obj_cnt += 1
        dl, du_ = self.slacks(x, st.xl, st.xu)
        obj, F_trial = torch.stack([
            obj.to(torch.float64),
            K.get_F(c, f, zl, zu, jacl, dl, du_, lb, ub, st.mu)]).tolist()
        st.x, st.y, st.zl, st.zu = x, y, zl, zu
        st.c, st.f, st.jacl = c, f, jacl
        st.obj_val, st.alpha = obj, alpha

        if F_trial > o.soft_resto_pderror_reduction_factor * st.soft_F:
            # revert to the backup iterate (solver.jl:362-367)
            st.x, st.y, st.c = st.backup_x, st.backup_y, st.backup_c
            st.status = int(S.ROBUST)
            st.rr_init_needed = True
            return st

        st.xl, st.xu = K.adjust_boundary(st.x, st.xl, st.xu, lb, ub, st.mu)
        st.soft_F = F_trial
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        sd, sc = self._sd_sc(st)
        theta, varphi, inf_pr, inf_du, inf_compl, icm = torch.stack([
            K.get_theta(st.c),
            K.get_varphi(st.obj_val, dl, du_, lb, ub, st.mu),
            *self._residuals(st, sd, sc),
            K.get_inf_compl(dl, du_, st.zl, st.zu, lb, ub, st.mu, sc),
        ]).tolist()
        st.k += 1
        if K.is_filter_acceptable(st.filter, theta, varphi):
            st.status = int(S.REGULAR)
            return st
        if st.k >= o.max_iter:
            st.status = int(S.MAXIMUM_ITERATIONS_EXCEEDED)
            return st

        st.t_cnt += 1
        st.inf_pr, st.inf_du, st.inf_compl = inf_pr, inf_du, inf_compl
        st.inf_compl_mu = icm
        st.log_row = self._log_row(st, st.mu, inf_pr, inf_du, inf_compl, False)
        # Ipopt-style original-NLP convergence check inside soft
        # restoration (the JAX package's, absent in the reference's
        # restore!): if the original KKT error already meets tol, the exit
        # is success, not restoration churn
        nlp_converged = max(inf_pr, inf_du, inf_compl) <= o.tol
        if not o.hessian_constant:
            self._refresh_hessian(st)
        p_rhs = self._aug_rhs(st, st.c, st.mu)
        ctx = self._factorize(st, 0.0, 0.0)
        st.ctx = self.persist_context(ctx)
        # restoration solves keep the exact refinement tolerance
        st.d, _, iters = self.kkt.solve_refine(ctx, p_rhs, mu=None)
        st.p = p_rhs
        st.factorization_cnt += 1
        st.backsolve_cnt += iters
        st.last_ir = iters
        st.ftype = K.FTYPE_F
        st.status = int(S.SOLVE_SUCCEEDED if nlp_converged else S.RESTORE)
        return st

    # ------------------------------------------------------------------
    # robust! — ℓ1-penalty restoration, one iteration (solver.jl:413-545)
    # ------------------------------------------------------------------

    def _init_robust_restorer(self, st: State) -> None:
        """initialize_robust_restorer! (restoration.jl:39-75)."""
        o = self.opts
        rho = o.rho
        c = st.c
        R = st.RR
        theta_ref, c_max = torch.stack([K.get_theta(c),
                                        K.get_inf_pr(c)]).tolist()
        mu_R = max(st.mu, c_max)
        R.x_ref = st.x
        R.theta_ref = theta_ref
        R.mu_R = mu_R
        R.tau_R = max(o.tau_min, 1.0 - mu_R)
        R.zeta = math.sqrt(mu_R)
        R.D_R, R.pp, R.nn, R.zp, R.zn = self._rr_slacks_init(st.x, c, mu_R)
        R.obj_val_R = float(K.get_obj_val_R(R.pp, R.nn, R.D_R, st.x, R.x_ref,
                                            rho, R.zeta))
        R.f_R = torch.zeros_like(st.x)
        R.filter = K.filter_reset(R.filter, st.theta_max)
        st.y = torch.zeros_like(st.y)
        st.zl = torch.where(self.lb, torch.clamp_max(st.zl, rho), 0.0)
        st.zu = torch.where(self.ub, torch.clamp_max(st.zu, rho), 0.0)
        st.t_cnt = 0
        st.del_w = 0.0
        st.rr_init_needed = False

    def _rr_slacks_init(self, x, c, mu):
        """The proximal weights, the p/n slacks and their duals at the start
        of robust restoration (restoration.jl:49-66).  ``mu`` is μ_R: a host
        float, or a ``(B,)`` tensor in a batch, as for every ``_RR`` helper
        below; ``BatchKernel`` calls them, so each formula lives here once.
        torch divides ``float / tensor`` as the reciprocal times the float
        and a lane column as a true quotient, so a batch lane and the
        single solve may differ there in the last bit."""
        D_R = torch.clamp_max(1.0 / torch.clamp_min(x.abs(), 1e-300), 1.0)
        nn = K.populate_RR_nn(c, mu, self.opts.rho)
        pp = c + nn
        mu = K.as_col(mu)
        return D_R, pp, nn, mu / pp, mu / nn

    def _update_monotone_RR(self, st: State, sc) -> None:
        """The restoration barrier's monotone decrease (barrier.jl:39-88)."""
        o = self.opts
        bo = o.barrier_options
        R = st.RR
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        mu_R, tau_R, zeta, filt = R.mu_R, R.tau_R, R.zeta, R.filter
        while True:
            icm = float(K.get_inf_compl_R(dl, du_, st.zl, st.zu, self.lb,
                                          self.ub, R.pp, R.zp, R.nn, R.zn,
                                          mu_R, sc))
            err = max(R.inf_pr_R, R.inf_du_R, icm)
            if not (mu_R >= o.mu_min and err <= o.barrier_tol_factor * mu_R):
                break
            mu_R = K.get_mu(mu_R, o.mu_min, bo.mu_linear_decrease_factor,
                            bo.mu_superlinear_decrease_power, o.tol)
            tau_R = max(o.tau_min, 1.0 - mu_R)
            zeta = math.sqrt(mu_R)
            filt = K.filter_reset(filt, st.theta_max)
        R.mu_R, R.tau_R, R.zeta, R.filter = mu_R, tau_R, zeta, filt

    def _aug_rhs_RR(self, st: State, mu) -> KKTVec:
        """set_aug_rhs_RR! (kernels.jl:133-158); ``mu`` is μ_R."""
        rho = self.opts.rho
        mu = K.as_col(mu)
        R = st.RR
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        px = -R.f_R + st.zl - st.zu - st.jacl
        py = (-st.c + R.pp - R.nn
              + (mu - (rho - st.y) * R.pp) / R.zp
              - (mu - (rho + st.y) * R.nn) / R.zn)
        return KKTVec(
            xp=px,
            y=py,
            zl=torch.where(self.lb, mu - dl * st.zl, 0.0),
            zu=torch.where(self.ub, du_ * st.zu - mu, 0.0),
        )

    def _finish_aug_solve_RR(self, R, y, dy, mu):
        """finish_aug_solve_RR (kernels.jl:251-257): the steps of the p/n
        slacks and their duals, (dpp, dnn, dzp, dzn); ``mu`` is μ_R."""
        rho, mu = self.opts.rho, K.as_col(mu)
        dzp = rho - y - dy - R.zp
        dzn = rho + y + dy - R.zn
        dpp = -R.pp + mu / R.zp - (R.pp / R.zp) * dzp
        dnn = -R.nn + mu / R.zn - (R.nn / R.zn) * dzn
        return dpp, dnn, dzp, dzn

    def _accept_RR(self, R, x, xl, xu, zl, zu, zp, zn, mu, zeta):
        """The accepted robust step's proximal gradient and σ-clipped duals
        (solver.jl:487-507), (f_R, zl, zu, zp, zn), at the trial point
        ``x`` with the trial p/n slacks; ``mu`` is μ_R and ``zeta`` ζ."""
        ks = self.opts.kappa_sigma
        pp, nn = R.pp_trial, R.nn_trial
        f_R = K.as_col(zeta) * R.D_R**2 * (x - R.x_ref)
        dl, du_ = self.slacks(x, xl, xu)
        zl = K.reset_bound_dual(zl, dl, self.lb, mu, ks)
        zu = K.reset_bound_dual(zu, du_, self.ub, mu, ks)
        mu = K.as_col(mu)
        pp_safe = torch.where(pp > 0, pp, 1.0)
        nn_safe = torch.where(nn > 0, nn, 1.0)
        zp = torch.maximum(torch.minimum(zp, ks * mu / pp_safe),
                           mu / (ks * pp_safe))
        zn = torch.maximum(torch.minimum(zn, ks * mu / nn_safe),
                           mu / (ks * nn_safe))
        return f_R, zl, zu, zp, zn

    def filter_line_search_RR(self, st: State) -> State:
        """The restoration problem's filter line search
        (line_search.jl:129-222): sets the trial point (with the trial p/n
        slacks), alpha, ftype and the RR filter in ``st``, and ``status``
        to LINESEARCH_SUCCEEDED / RESTORATION_FAILED / REGULAR (second
        chance) / SOLVED_TO_ACCEPTABLE_LEVEL /
        SEARCH_DIRECTION_BECOMES_TOO_SMALL."""
        o, p = self.opts, self.prob
        eps = self.eps
        lb, ub = self.lb, self.ub
        R, d = st.RR, st.d
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (theta_R, varphi_R, varphi_d_R, alpha_max, alpha_z,
         rel_norm) = torch.stack([
            K.get_theta_R(st.c, R.pp, R.nn),
            K.get_varphi_R(R.obj_val_R, dl, du_, lb, ub, R.pp, R.nn, R.mu_R),
            K.get_varphi_d_R(R.f_R, dl, du_, lb, ub, d.xp, R.pp, R.nn, R.dpp,
                             R.dnn, R.mu_R, o.rho),
            K.get_alpha_max_R(st.x, st.xl, st.xu, d.xp, lb, ub, R.pp, R.dpp,
                              R.nn, R.dnn, R.tau_R),
            K.get_alpha_z_R(st.zl, st.zu, d.zl, d.zu, lb, ub, R.zp, R.dzp,
                            R.zn, R.dzn, R.tau_R),
            K.get_rel_search_norm(st.x, d.xp),
        ]).tolist()
        alpha_min = K.get_alpha_min(
            theta_R, varphi_d_R, st.theta_min, o.gamma_theta, o.gamma_phi,
            o.alpha_min_frac, o.delta, o.s_theta, o.s_phi,
        )
        small_search_norm = rel_norm < 10 * eps
        switching = K.is_switching(varphi_d_R, alpha_max, o.s_phi, o.delta,
                                   theta_R, o.s_theta)

        st.l_cnt = 1
        alpha = alpha_max
        while True:
            x_t = st.x + alpha * d.xp
            pp_t = R.pp + alpha * R.dpp
            nn_t = R.nn + alpha * R.dnn
            obj_R_t = K.get_obj_val_R(pp_t, nn_t, R.D_R, x_t, R.x_ref, o.rho,
                                      R.zeta)
            c_t = self.eval_cons(st, x_t)
            st.con_cnt += 1
            dl_t, du_t = self.slacks(x_t, st.xl, st.xu)
            obj_R_t, th_t, ph_t = torch.stack([
                obj_R_t, K.get_theta_R(c_t, pp_t, nn_t),
                K.get_varphi_R(obj_R_t, dl_t, du_t, lb, ub, pp_t, nn_t,
                               R.mu_R),
            ]).tolist()
            st.x_trial, st.c_trial = x_t, c_t
            R.pp_trial, R.nn_trial, R.obj_val_R_trial = pp_t, nn_t, obj_R_t
            armijo = K.is_armijo(ph_t, varphi_R, o.eta_phi, alpha, varphi_d_R)
            ftype = K.get_ftype(
                R.filter, theta_R, th_t, varphi_R, ph_t, switching, armijo,
                st.theta_min, o.obj_max_inc, o.gamma_theta, o.gamma_phi,
                p.has_constraints, eps,
            )
            accept_f = ftype in (K.FTYPE_F, K.FTYPE_H)
            if accept_f:
                st.ftype = ftype
            if accept_f or small_search_norm:
                code = 0
                break
            alpha_next = alpha / 2.0
            alpha = alpha_next
            if alpha_next < alpha_min:
                rfc = st.restoration_fail_count + 1
                st.restoration_fail_count = rfc
                if rfc >= 4:
                    code = S.RESTORATION_FAILED
                else:
                    # second chance: reset the duals and the filter
                    st.y = torch.zeros_like(st.y)
                    st.zl = self._where_bound(lb)
                    st.zu = self._where_bound(ub)
                    st.filter = K.filter_reset(st.filter, st.theta_max)
                    st.k += 1
                    st.t_cnt += 1
                    code = S.REGULAR
                break
            if alpha_next < eps * 10:
                code = (S.SOLVED_TO_ACCEPTABLE_LEVEL if st.acceptable_cnt > 0
                        else S.SEARCH_DIRECTION_BECOMES_TOO_SMALL)
                break
            st.l_cnt += 1
        st.alpha, st.alpha_z = alpha, alpha_z

        if code != 0:
            st.status = int(code)
            return st
        if (not switching) or (not armijo):
            R.filter = K.filter_augment(R.filter, th_t, ph_t, o.gamma_theta)
        st.status = int(S.LINESEARCH_SUCCEEDED)
        return st

    def robust_step(self, st: State) -> State:
        o, p = self.opts, self.prob
        lb, ub = self.lb, self.ub
        if st.rr_init_needed:
            self._init_robust_restorer(st)
        if not o.jacobian_constant:
            st.jac = p.eval_jac(st.scal, st.x, st.theta)
            st.jac_cnt += 1
        st.jacl = self.kkt.jtprod(st.jac, st.y)

        R = st.RR
        sd, sc = self._sd_sc(st)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (sc, inf_pr, inf_du, inf_compl, inf_pr_R, inf_du_R,
         inf_compl_R) = torch.stack([
            sc, *self._residuals(st, sd, sc),
            K.get_inf_pr_R(st.c, R.pp, R.nn),
            K.get_inf_du_R(R.f_R, st.y, st.zl, st.zu, st.jacl, R.zp, R.zn,
                           o.rho, sd),
            K.get_inf_compl_R(dl, du_, st.zl, st.zu, lb, ub, R.pp, R.zp, R.nn,
                              R.zn, 0.0, sc),
        ]).tolist()
        st.inf_pr, st.inf_du, st.inf_compl = inf_pr, inf_du, inf_compl
        R.inf_pr_R, R.inf_du_R, R.inf_compl_R = inf_pr_R, inf_du_R, inf_compl_R
        st.log_row = self._log_row(st, R.mu_R, inf_pr_R, inf_du_R,
                                   inf_compl_R, True)

        status = S.ROBUST
        if st.k >= o.max_iter:
            status = S.MAXIMUM_ITERATIONS_EXCEEDED
        # Ipopt-style original-NLP convergence check inside robust
        # restoration (the JAX package's, absent in the reference): if the
        # iterate satisfies the original KKT conditions to tol, the run is
        # a success whatever the restoration bookkeeping says
        if max(inf_pr, inf_du, inf_compl) <= o.tol:
            status = S.SOLVE_SUCCEEDED
        st.status = int(status)

        # The restoration problem is solved (err_R <= tol, solver.jl:445).
        # That certifies local infeasibility only if the point violates
        # the constraints; at an (almost) feasible point the JAX package
        # first recovers least-squares multipliers (robust restoration
        # zeroed y at entry) and reports success if the original KKT
        # conditions then hold, RESTORATION_FAILED otherwise.
        if (max(inf_pr_R, inf_du_R, inf_compl_R) <= o.tol
                and status == S.ROBUST):
            if inf_pr > o.tol:
                st.status = int(S.INFEASIBLE_PROBLEM_DETECTED)
                return st
            y_new, _ = self._least_squares_duals(st)
            jacl = self.kkt.jtprod(st.jac, y_new)
            y_old, jacl_old = st.y, st.jacl
            st.y, st.jacl = y_new, jacl
            sd2, sc2 = self._sd_sc(st)
            res = torch.stack(self._residuals(st, sd2, sc2)).tolist()
            if max(res) <= o.tol:
                st.inf_pr, st.inf_du, st.inf_compl = res
                st.status = int(S.SOLVE_SUCCEEDED)
            else:
                st.y, st.jacl = y_old, jacl_old
                st.status = int(S.RESTORATION_FAILED)
            return st
        if status != S.ROBUST:
            return st

        self._update_monotone_RR(st, sc)
        if not o.hessian_constant:
            self._refresh_hessian(st, is_resto=True)
        p_rhs = self._aug_rhs_RR(st, R.mu_R)
        st.p = p_rhs
        ctx, d, ok = self.inertia_correction(st, p_rhs, rr=True)
        st.d = d
        st.ctx = self.persist_context(ctx)
        if not ok:
            st.status = int(S.RESTORATION_FAILED)
            return st

        R.dpp, R.dnn, R.dzp, R.dzn = self._finish_aug_solve_RR(
            R, st.y, d.y, R.mu_R)
        self.filter_line_search_RR(st)
        if st.status != S.LINESEARCH_SUCCEEDED:
            return st

        x = st.x_trial
        y = st.y + st.alpha * d.y
        zl = st.zl + st.alpha_z * d.zl
        zu = st.zu + st.alpha_z * d.zu
        zp = R.zp + st.alpha_z * R.dzp
        zn = R.zn + st.alpha_z * R.dzn
        R.f_R, st.zl, st.zu, R.zp, R.zn = self._accept_RR(
            R, x, st.xl, st.xu, zl, zu, zp, zn, R.mu_R, R.zeta)
        R.pp, R.nn = R.pp_trial, R.nn_trial
        R.obj_val_R = R.obj_val_R_trial
        st.xl, st.xu = K.adjust_boundary(x, st.xl, st.xu, lb, ub, st.mu)
        obj = self.eval_obj(st, x)
        st.f = p.eval_grad(st.scal, x, st.theta)
        st.obj_cnt += 1
        st.grad_cnt += 1
        st.x, st.y, st.c = x, y, st.c_trial
        # exit check (solver.jl:509-536)
        dl, du_ = self.slacks(x, st.xl, st.xu)
        obj, theta, varphi = torch.stack([
            obj.to(torch.float64), K.get_theta(st.c),
            K.get_varphi(obj, dl, du_, lb, ub, st.mu)]).tolist()
        st.obj_val = obj
        st.k += 1
        st.t_cnt += 1
        if (K.is_filter_acceptable(st.filter, theta, varphi)
                and theta <= o.required_infeasibility_reduction * R.theta_ref):
            st.y, ls_ctx = self._least_squares_duals(st)
            st.ctx = self.persist_context(ls_ctx)
            st.status = int(S.REGULAR)
        else:
            st.status = int(S.ROBUST)
        return st
