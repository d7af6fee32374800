"""The batched interior-point iteration of ``solve_batch`` — port of
``batched_step`` / ``whole_batched`` inside
``madnlp_tpu/ipm/solver.py:MadNLPSolver.solve_batch``.

The JAX package runs a batch of same-structure scenarios by ``jax.vmap``
of its step functions: every ``lax.cond`` and ``while_loop`` then runs per
lane under a mask.  The port's iteration makes its decisions on the host
(:mod:`.step`), which ``vmap`` cannot map, so the batch axis is written
out here:

* vectors are ``(B, ·)`` device tensors, per-lane scalars and counters
  ``(B,)`` numpy arrays, the filter ``(B, capacity)`` (:class:`BatchState`);
* each decision point reads one ``(B, k)`` stack from the device for all
  lanes — the single solve's one read per decision, made B wide;
* every loop (the barrier update, the δ ladder, Richardson refinement, the
  backtracking line search, SOC) runs while any lane still needs it; a lane
  that has left a loop keeps its values, and the counters count only the
  work of lanes still in it.  Lane ``i`` thus follows the single solve of
  scenario ``i`` (:class:`.step.Kernel`), up to the rounding of batched
  reductions.

The vector kernels (:mod:`.kernels`) are shared with the single solve and
broadcast over the lane axis; the scalar predicates run lane by lane.  Every
factorization goes through the batched band kernel K3 and every backsolve
through K4, under the mask of the lanes that need them.

The step options run per lane as in the single solve: the adaptive
barriers (:func:`.barrier.update_barrier_adaptive_lanes`, whose probing
solves read each lane's last factorization, ``BatchState.ctx``), the
inertia-free and inertia-ignoring corrections of the δ ladder, compact
L-BFGS (:func:`.quasi_newton.lbfgs_update_compact_lanes`, its SMW payload
one K4 launch of 2p columns per factorization), GMRES refinement and the
K2.5 scaling (both inside the KKT system).

:meth:`BatchKernel.step` is one step of the three-phase state machine
(``batched_step``): the regular, soft restoration and robust restoration
passes each run on the lanes whose status held that phase at the start of
the step, as ``lax.switch`` picks one branch per lane, so a lane that the
regular pass sends to RESTORE takes its first restore step in the next
batched step.  Each pass factors its own lanes (one K3 launch per
factorization of the pass, the δ ladder's included) and solves them (K4);
the restoration systems take the same band, ordering and launch plans as
the regular ones, since their terms reach the band only through the
diagonals.  A lane that has finished is not touched again.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kkt.vec import KKTVec, lane_where
from ..utils.options import (
    BarrierUpdate,
    DualInitialization,
    HessianApproximation,
    InertiaCorrection,
)
from ..utils.status import Status as S
from . import kernels as K
from .barrier import update_barrier_adaptive_lanes
from .quasi_newton import init_hessian_lowrank_lanes, lbfgs_update_compact_lanes
from .state import BatchState, batch_state_zeros
from .step import Kernel


def _finite_lanes(v) -> torch.Tensor:
    """Per lane: every entry of ``v (B, ...)``, or of each tensor of a
    batched LowRankHessian, is finite."""
    if isinstance(v, tuple):
        return torch.stack([_finite_lanes(a) for a in v]).all(0)
    return torch.isfinite(v).reshape(v.shape[0], -1).all(-1)


class BatchKernel:
    """The step functions of :class:`.step.Kernel` over a lane axis."""

    def __init__(self, kernel: Kernel):
        self.single = kernel
        self.prob, self.opts, self.kkt = kernel.prob, kernel.opts, kernel.kkt
        self.lb, self.ub = kernel.lb, kernel.ub
        self.llb, self.uub = kernel.llb, kernel.uub
        self.eps = kernel.eps
        self.inertia_method = kernel.inertia_method

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _t(self, a) -> torch.Tensor:
        """Host per-lane values -> float64 ``(B,)`` on the device."""
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.prob.device)

    def _sel(self, mask, new, old):
        """Lane by lane: ``new`` where the numpy mask holds, else ``old``
        (tensors with a lane axis, or tuples of them: a KKTVec, a KKT
        context)."""
        on = torch.as_tensor(np.asarray(mask, dtype=bool),
                             device=self.prob.device)
        return lane_where(on, new, old)

    def slacks(self, x, xl, xu):
        return K.slacks(x, xl, xu, self.lb, self.ub)

    def _bound_ones(self, mask, lanes):
        return torch.where(mask, 1.0, 0.0).to(torch.float64).expand(
            lanes, -1).clone()

    def eval_obj(self, st, w):
        return self.prob.eval_obj(st.scal, w, st.theta)

    def eval_cons(self, st, w):
        return self.prob.eval_cons(st.scal, w, st.theta)

    def _persist(self, st: BatchState, ctx, lanes) -> None:
        """Keep ``ctx`` as the last factorization of the lanes in
        ``lanes`` (adaptive barriers only; the f64 operator band dropped,
        as :meth:`.step.Kernel.persist_context` does)."""
        ctx = self.single.persist_context(ctx)
        if ctx is not None:
            st.ctx = self._sel(lanes, ctx, st.ctx)

    def _zero_context(self, lanes: int):
        """The single solve's zero context on every lane."""
        def spread(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                items = [spread(a) for a in v]
                return (type(v)(*items) if hasattr(v, "_fields")
                        else tuple(items))
            return v.expand((lanes,) + v.shape).clone()

        return spread(self.kkt.zero_context())

    # ------------------------------------------------------------------
    # quasi-Newton / exact Hessian refresh (callbacks.jl:145-190), per lane
    # ------------------------------------------------------------------

    def _refresh_hessian(self, st: BatchState, lanes,
                         is_resto: bool = False) -> None:
        """:meth:`.step.Kernel._refresh_hessian` of the lanes in
        ``lanes``: the model's Hessian, or each lane's compact L-BFGS
        update from its secant pair (the Gilbert–Lemaréchal start where
        the lane has no gradient pair yet)."""
        p, o = self.prob, self.opts
        if self.single.hess_approx == HessianApproximation.EXACT:
            st.hess = self._sel(lanes, p.eval_lag_hess(
                st.scal, st.x, st.y, st.theta, is_resto=is_resto), st.hess)
            st.hess_cnt[lanes] += 1
            return
        n = p.n
        qn = st.qn
        secant = lanes & (st.grad_cnt >= 2)
        if secant.any():
            sk = st.x[:, :n] - qn.last_x
            yk = st.f[:, :n] - qn.last_g
            if p.m > 0:
                yk = yk + st.jacl[:, :n]
                yk = yk - p.eval_jtprod_x(st.scal, qn.last_x, st.y, st.theta)
            st.hess, qn = lbfgs_update_compact_lanes(
                st.hess, qn, sk, yk, o.quasi_newton_options, secant)
        start = lanes & ~secant
        if start.any():
            st.hess = init_hessian_lowrank_lanes(
                st.hess, st.f[:, :n], st.obj_val,
                o.quasi_newton_options.init_value, start)
        st.qn = qn._replace(last_x=self._sel(lanes, st.x[:, :n], qn.last_x),
                            last_g=self._sel(lanes, st.f[:, :n], qn.last_g))

    # ------------------------------------------------------------------
    # initialization (solver.jl:14-77 + nlpmodels.jl:593-636), per lane
    # ------------------------------------------------------------------

    def initialize(self, theta: torch.Tensor) -> BatchState:
        """``theta``: the ``(B, ...)`` parameters of the B scenarios."""
        p, o = self.prob, self.opts
        dev = p.device
        B = int(theta.shape[0])
        st = batch_state_zeros(B, p.nw, p.m, p.nnzj_aug, p.hess_template(B),
                               o.filter_capacity, theta, dev, n=p.n,
                               qn_mem=self.single.qn_mem)
        lb, ub = self.lb, self.ub

        xl = torch.as_tensor(p.xl0, device=dev)
        xu = torch.as_tensor(p.xu0, device=dev)
        if p.eqrelax_mask.any():
            er = torch.as_tensor(p.eqrelax_mask, device=dev)
            xl2, xu2 = K.set_initial_bounds(xl, xu, lb, ub, o.bound_relax_factor)
            xl = torch.where(er, xl2, xl)
            xu = torch.where(er, xu2, xu)
        xl, xu = K.set_initial_bounds(xl, xu, lb, ub, o.bound_relax_factor)

        x0 = torch.as_tensor(p.model.x0, device=dev)
        if p.fixed_mask.any():
            x0 = torch.where(p.t.fixed, p.t.xl_fixed, x0)
        n = p.n
        # every scenario starts from the model's initial point
        xv = K.initialize_variables(x0, xl[:n], xu[:n], lb[:n], ub[:n],
                                    o.bound_push, o.bound_fac).expand(B, n)
        # slack init from each scenario's unscaled constraint values
        g0 = (p._call(p.model.cons, xv, theta=theta) if p.m
              else p.zeros(B, 0))
        s0 = K.initialize_variables(p.gather_ineq(g0), xl[n:], xu[n:],
                                    lb[n:], ub[n:], o.bound_push, o.bound_fac)
        w0 = torch.cat([xv, s0], -1)
        xl = xl.expand(B, -1).clone()
        xu = xu.expand(B, -1).clone()
        y0 = (torch.as_tensor(p.model.y0, device=dev) * p.sign).expand(B, -1)

        scal = p.compute_scaling(w0, theta)
        if p.m:
            y0 = y0 / torch.clamp_min(scal.con_scale, 1e-300)
        cs_slk = p.gather_ineq(scal.con_scale)
        w0[:, n:] = w0[:, n:] * cs_slk
        xl[:, n:] = xl[:, n:] * cs_slk
        xu[:, n:] = xu[:, n:] * cs_slk

        st.x, st.y, st.xl, st.xu, st.scal = w0, y0.contiguous(), xl, xu, scal
        st.zl = self._bound_ones(lb, B)
        st.zu = self._bound_ones(ub, B)
        st.mu[:] = o.barrier_options.mu_init
        st.tau[:] = max(o.tau_min, 1.0 - o.barrier_options.mu_init)

        st.jac = p.eval_jac(scal, w0, theta)
        st.f = p.eval_grad(scal, w0, theta)
        obj = p.eval_obj(scal, w0, theta)
        st.c = p.eval_cons(scal, w0, theta)
        st.jacl = self.kkt.jtprod(st.jac, st.y)
        for c in ("obj_cnt", "grad_cnt", "con_cnt", "jac_cnt"):
            getattr(st, c)[:] = 1
        every = np.ones(B, dtype=bool)
        if self.single.hess_approx == HessianApproximation.EXACT:
            st.hess = p.eval_lag_hess(scal, w0, st.y, theta)
            st.hess_cnt[:] = 1
        else:
            st.hess = init_hessian_lowrank_lanes(
                st.hess, st.f[:, :n], obj.to(torch.float64).cpu().numpy(),
                o.quasi_newton_options.init_value, every)
            st.qn = st.qn._replace(last_x=w0[:, :n], last_g=st.f[:, :n])
        if self.single._persist_ctx:
            st.ctx = self._zero_context(B)

        if (not o.dual_initialized
                and o.dual_initialization_method == DualInitialization.LEAST_SQUARES
                and p.m > 0):
            st.y, ls_ctx = self._least_squares_duals(st)
            self._persist(st, ls_ctx, every)
            st.jacl = self.kkt.jtprod(st.jac, st.y)

        finite = [_finite_lanes(v) for v in (st.hess, st.jac, st.c, st.f)]
        read = torch.stack(finite + [torch.isfinite(obj)], -1).to(torch.float64)
        read = torch.cat([read, torch.stack([K.get_theta(st.c),
                                             obj.to(torch.float64)], -1)], -1)
        read = read.cpu().numpy()
        theta_c, st.obj_val = read[:, 5], read[:, 6].copy()
        st.theta_max = 1e4 * np.maximum(1.0, theta_c)
        st.theta_min = 1e-4 * np.maximum(1.0, theta_c)
        st.filter = K.filter_lanes(K.filter_reset, st.filter,
                                   np.ones(B, dtype=bool), st.theta_max)
        # NaN/Inf guards on the first evaluations (callbacks.jl:13-15);
        # the last failing check wins, as in the JAX package
        st.status[:] = int(S.REGULAR)
        for col, code in enumerate((
                S.INVALID_NUMBER_HESSIAN_LAGRANGIAN, S.INVALID_NUMBER_JACOBIAN,
                S.INVALID_NUMBER_CONSTRAINTS, S.INVALID_NUMBER_GRADIENT,
                S.INVALID_NUMBER_OBJECTIVE)):
            st.status[read[:, col] == 0.0] = int(code)
        return st

    def _least_squares_duals(self, st: BatchState, lanes=None):
        """The single solve's least-squares duals of the lanes in ``lanes``
        (every lane by default; zero on the others): one uncounted K3
        factorization and its refinement.  Returns the duals and the
        factorization's context."""
        p = self.prob
        B = st.lanes
        if lanes is None:
            lanes = np.ones(B, dtype=bool)
        ones = p.zeros(B, p.nw) + 1.0
        ctx = self.kkt.build_and_factorize(
            hess=p.hess_template(B), jac=st.jac, reg=ones,
            du_diag=p.zeros(B, p.m), dl=ones, du_=ones,
            zl=p.zeros(B, p.nw), zu=p.zeros(B, p.nw), active=lanes,
        )
        rhs = KKTVec(xp=-st.f + st.zl - st.zu, y=p.zeros(B, p.m),
                     zl=p.zeros(B, p.nw), zu=p.zeros(B, p.nw))
        d, ok, _ = self.kkt.solve_refine(ctx, rhs, active=lanes)
        too_big = (d.y.abs().amax(-1).cpu().numpy()
                   > self.opts.constr_mult_init_max)
        return self._sel(ok & ~too_big, d.y, torch.zeros_like(d.y)), ctx

    # ------------------------------------------------------------------
    # barrier update (monotone, barrier.jl:12-34; adaptive: barrier.py)
    # ------------------------------------------------------------------

    def update_barrier(self, st: BatchState, sc, act):
        b = self.opts.barrier
        if b == BarrierUpdate.MONOTONE:
            return self.update_barrier_monotone(st, sc, act)
        return update_barrier_adaptive_lanes(
            self, st, sc, act,
            "quality_function" if b == BarrierUpdate.QUALITY_FUNCTION
            else "loqo")

    def update_barrier_monotone(self, st: BatchState, sc, act):
        o = self.opts
        bo = o.barrier_options
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        sc_t = self._t(sc)

        def compl_at(mu):
            return K.get_inf_compl(dl, du_, st.zl, st.zu, self.lb, self.ub,
                                   self._t(mu), sc_t).cpu().numpy()

        mu, tau, filt = st.mu.copy(), st.tau.copy(), st.filter
        icm = compl_at(mu)
        floor = max(o.mu_min, o.tol / 10)

        def still(loop):
            worst = np.maximum(np.maximum(st.inf_pr, st.inf_du), icm)
            return loop & (mu > floor) & (worst <= o.barrier_tol_factor * mu)

        loop = still(act.copy())
        while loop.any():
            mu_new = np.array([
                K.get_mu(float(m), o.mu_min, bo.mu_linear_decrease_factor,
                         bo.mu_superlinear_decrease_power, o.tol) for m in mu])
            # the old μ, as in the single solve (barrier.jl:20-31)
            icm = np.where(loop, compl_at(mu), icm)
            tau = np.where(loop, [K.get_tau(float(m), o.tau_min) for m in mu],
                           tau)
            filt = K.filter_lanes(K.filter_reset, filt, loop, st.theta_max)
            mu = np.where(loop, mu_new, mu)
            loop = still(loop)
        st.mu, st.tau, st.filter = mu, tau, filt
        st.inf_compl_mu = np.where(act, icm, st.inf_compl_mu)

    # ------------------------------------------------------------------
    # Newton system assembly + inertia correction (solver.jl:611-783)
    # ------------------------------------------------------------------

    def _aug_rhs(self, st: BatchState, c, mu) -> KKTVec:
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        mu = self._t(mu)
        px = -st.f + st.zl - st.zu - st.jacl
        px = K.dual_inf_perturbation(px, self.llb, self.uub, mu,
                                     self.opts.kappa_d)
        mu = mu[:, None]
        return KKTVec(
            xp=px,
            y=-c,
            zl=torch.where(self.lb, mu - dl * st.zl, 0.0),
            zu=torch.where(self.ub, du_ * st.zu - mu, 0.0),
        )

    def _factorize(self, st: BatchState, del_w, del_c, lanes, prev,
                   rr: bool = False):
        """The single solve's ``_factorize`` of the lanes in ``lanes`` (K3);
        ``rr``: the robust-restoration system of each lane."""
        o, p = self.opts, self.prob
        B = st.lanes
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        del_w = self._t(del_w)[:, None]
        del_c = self._t(del_c)[:, None]
        if rr:
            R = st.RR
            reg = (o.default_primal_regularization
                   + self._t(R.zeta)[:, None] * R.D_R**2 + del_w)
            du_diag = (-o.default_dual_regularization - R.pp / R.zp
                       - R.nn / R.zn - del_c)
        else:
            reg = p.zeros(B, p.nw) + o.default_primal_regularization + del_w
            du_diag = p.zeros(B, p.m) - o.default_dual_regularization - del_c
        return self.kkt.build_and_factorize(
            st.hess, st.jac, reg, du_diag, dl, du_, st.zl, st.zu, rr=rr,
            active=lanes, prev=prev)

    def inertia_correction(self, st: BatchState, p_rhs: KKTVec, act,
                           rr: bool = False):
        """The δ ladder of every lane in ``act`` at once, under the
        resolved inertia strategy: each attempt factors (K3) and solves
        only the lanes still climbing, the others keep their factor and
        direction.  ``rr``: the robust-restoration system, whose solves
        keep the exact refinement tolerance and whose δ_c follows μ_R.
        Returns (ctx, d, success (B,))."""
        o, p = self.opts, self.prob
        B = st.lanes
        ok = np.zeros(B, dtype=bool)
        # the strategies that see no inertia take δ_c on every retry
        nzero = np.ones(B, dtype=np.int64)
        ctx = d = None
        mu_refine = None if rr else st.mu
        mu = st.RR.mu_R if rr else st.mu
        method = self.inertia_method
        if method == InertiaCorrection.FREE:
            g, p0 = self.single._free_test_data(st, self._t(mu))

        def solve(ctx, rhs, lanes):
            return self.kkt.solve_refine(ctx, rhs, mu=mu_refine, active=lanes)

        def attempt(lanes, del_w, del_c):
            nonlocal ctx, d
            ctx = self._factorize(st, del_w, del_c, lanes, ctx, rr=rr)
            if method == InertiaCorrection.BASED:
                pos, zero, _ = self.kkt.inertia(ctx).T
                # the solve runs (and is counted) whatever the inertia
                dn, solved, iters = solve(ctx, p_rhs, lanes)
                good = (zero == 0) & (pos == p.nw) & solved
                nzero[lanes] = zero[lanes]
            elif method == InertiaCorrection.IGNORE:
                dn, good, iters = solve(ctx, p_rhs, lanes)
            else:
                # the normal step d₀, the full step and the curvature
                # test of t = d - d₀ (see Kernel._attempt_free)
                d0, ok0, it0 = solve(ctx, p0, lanes)
                dn, ok1, it1 = solve(ctx, p_rhs, lanes)
                iters = it0 + it1
                t = dn.xp - d0.xp
                wx = self.kkt.mul_hess_blk(ctx, t)
                tWt, tWd0, gd0, tt = torch.stack([
                    (wx * t).sum(-1), (wx * d0.xp).sum(-1),
                    (g * d0.xp).sum(-1), (t * t).sum(-1)]).cpu().numpy()
                good = ok0 & ok1 & ((tWt + np.maximum(tWd0 - gd0, 0.0)
                                     - o.inertia_free_tol * tt) >= 0.0)
            d = dn if d is None else self._sel(lanes, dn, d)
            st.factorization_cnt[lanes] += 1
            st.backsolve_cnt[lanes] += iters[lanes]
            st.last_ir[lanes] = iters[lanes]
            ok[lanes] = good[lanes]

        del_w = np.zeros(B)
        del_c = np.zeros(B)
        n_trial = np.zeros(B, dtype=np.int64)
        fail = np.zeros(B, dtype=bool)
        attempt(act, del_w, del_c)
        loop = act & ~ok
        while loop.any():
            for i in np.flatnonzero(loop):
                del_w[i] = self.single._next_del_w(
                    int(n_trial[i]), float(del_w[i]), float(st.del_w_last[i]))
                # δ_c on rank-deficient Jacobian (num_zero != 0)
                del_c[i] = (o.jacobian_regularization_value
                            * float(mu[i]) ** o.jacobian_regularization_exponent
                            if nzero[i] != 0 else 0.0)
                n_trial[i] += 1
                if del_w[i] > o.max_hessian_perturbation:
                    fail[i] = True    # keep the previous payloads (unused)
            go = loop & ~fail
            if go.any():
                attempt(go, del_w, del_c)
            loop = act & ~ok & ~fail
        st.del_w = np.where(act, del_w, st.del_w)
        st.del_c = np.where(act, del_c, st.del_c)
        moved = act & (del_w != 0.0)
        st.del_w_last[moved] = del_w[moved]
        return ctx, d, ok & ~fail

    # ------------------------------------------------------------------
    # second-order correction (solver.jl:547-608)
    # ------------------------------------------------------------------

    def second_order_correction(self, st: BatchState, ctx, lanes, alpha_max,
                                theta, varphi, theta_trial0, varphi_d,
                                switching):
        """SOC for the lanes in ``lanes``.  Returns (accepted (B,),
        alpha_soc (B,), ftype (B,), x_trial, obj_trial (B,), c_trial), the
        trial values replaced on the accepted lanes."""
        o, p = self.opts, self.prob
        B = st.lanes
        mu_t, tau_t = self._t(st.mu), self._t(st.tau)
        wy = st.c_trial + self._t(alpha_max)[:, None] * st.c
        theta_soc_old = np.array(theta_trial0, dtype=np.float64)
        accepted = np.zeros(B, dtype=bool)
        alpha_soc = np.zeros(B)
        ftype = np.zeros(B, dtype=np.int64)
        x_acc, c_acc = st.x_trial, st.c_trial
        obj_acc = st.obj_val_trial.copy()
        run = lanes.copy()
        for _ in range(max(o.max_soc, 1)):
            if not run.any():
                break
            rhs = self._aug_rhs(st, wy, st.mu)
            w1, _, iters = self.kkt.solve_refine(ctx, rhs, mu=st.mu,
                                                 active=run)
            st.backsolve_cnt[run] += iters[run]
            st.last_ir[run] = iters[run]
            a_soc = K.get_alpha_max(st.x, st.xl, st.xu, w1.xp, tau_t,
                                    self.lb, self.ub)
            x_soc = st.x + a_soc[:, None] * w1.xp
            c_soc = self.eval_cons(st, x_soc)
            obj_soc = self.eval_obj(st, x_soc)
            st.con_cnt[run] += 1
            st.obj_cnt[run] += 1
            dl_t, du_t = self.slacks(x_soc, st.xl, st.xu)
            read = torch.stack([
                obj_soc.to(torch.float64), K.get_theta(c_soc),
                K.get_varphi(obj_soc, dl_t, du_t, self.lb, self.ub, mu_t),
                a_soc,
            ], -1).cpu().numpy()
            now = np.zeros(B, dtype=bool)
            more = np.zeros(B, dtype=bool)
            for i in np.flatnonzero(run):
                obj_s, theta_s, varphi_s, a_s = (float(v) for v in read[i])
                filter_ok = K.is_filter_acceptable(
                    K.filter_lane(st.filter, i), theta_s, varphi_s)
                case1 = bool(theta[i] <= st.theta_min[i]) and bool(switching[i])
                if case1:
                    # st.alpha is the previous iteration's step, as in the
                    # single solve
                    accept_now = filter_ok and K.is_armijo(
                        varphi_s, varphi[i], o.eta_phi, float(st.alpha[i]),
                        varphi_d[i])
                else:
                    accept_now = filter_ok and K.is_sufficient_progress(
                        theta_s, theta[i], o.gamma_theta, varphi_s, varphi[i],
                        o.gamma_phi, p.has_constraints, self.eps)
                if accept_now:
                    now[i] = accepted[i] = True
                    alpha_soc[i], obj_acc[i] = a_s, obj_s
                    ftype[i] = K.FTYPE_SOC_F if case1 else K.FTYPE_SOC_H
                elif (not filter_ok) or theta_s > o.kappa_soc * theta_soc_old[i]:
                    pass
                else:
                    more[i] = True
                    theta_soc_old[i] = theta_s
            if now.any():
                x_acc = self._sel(now, x_soc, x_acc)
                c_acc = self._sel(now, c_soc, c_acc)
            if more.any():
                wy = self._sel(more, w1.y, wy)
            run = more
        return accepted, alpha_soc, ftype, x_acc, obj_acc, c_acc

    # ------------------------------------------------------------------
    # filter line search (line_search.jl:6-123)
    # ------------------------------------------------------------------

    def filter_line_search(self, st: BatchState, ctx, d: KKTVec, lanes):
        """The backtracking search of every lane in ``lanes`` at once; sets
        each lane's trial point, alpha, ftype, filter and status as the
        single solve's ``filter_line_search`` does."""
        o, p = self.opts, self.prob
        eps = self.eps
        lb, ub = self.lb, self.ub
        B = st.lanes
        mu_t, tau_t = self._t(st.mu), self._t(st.tau)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (theta, varphi, varphi_d, alpha_max, alpha_z, rel_norm,
         dnorm) = torch.stack([
            K.get_theta(st.c),
            K.get_varphi(self._t(st.obj_val), dl, du_, lb, ub, mu_t),
            K.get_varphi_d(st.f, dl, du_, lb, ub, d.xp, mu_t),
            K.get_alpha_max(st.x, st.xl, st.xu, d.xp, tau_t, lb, ub),
            K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, tau_t, lb, ub),
            K.get_rel_search_norm(st.x, d.xp),
            d.xp.abs().amax(-1),
        ], -1).cpu().numpy().T
        alpha_min = np.array([K.get_alpha_min(
            theta[i], varphi_d[i], st.theta_min[i], o.gamma_theta,
            o.gamma_phi, o.alpha_min_frac, o.delta, o.s_theta, o.s_phi,
        ) for i in range(B)])
        small = rel_norm < 10 * eps
        # (theta = 2.0 here, as in the JAX package)
        switching = np.array([K.is_switching(
            varphi_d[i], alpha_max[i], o.s_phi, o.delta, 2.0, o.s_theta)
            for i in range(B)])

        st.l_cnt[lanes] = 1
        alpha = alpha_max.copy()
        code = np.zeros(B, dtype=np.int64)
        th_t = np.zeros(B)
        ph_t = np.zeros(B)
        armijo = np.zeros(B, dtype=bool)
        second_chance = np.zeros(B, dtype=bool)
        searching = lanes.copy()
        while searching.any():
            x_t = st.x + self._t(alpha)[:, None] * d.xp
            obj_t = self.eval_obj(st, x_t)
            c_t = self.eval_cons(st, x_t)
            st.obj_cnt[searching] += 1
            st.con_cnt[searching] += 1
            dl_t, du_t = self.slacks(x_t, st.xl, st.xu)
            read = torch.stack([
                obj_t.to(torch.float64), K.get_theta(c_t),
                K.get_varphi(obj_t, dl_t, du_t, lb, ub, mu_t),
            ], -1).cpu().numpy()
            st.x_trial = self._sel(searching, x_t, st.x_trial)
            st.c_trial = self._sel(searching, c_t, st.c_trial)
            st.obj_val_trial = np.where(searching, read[:, 0], st.obj_val_trial)
            th_t = np.where(searching, read[:, 1], th_t)
            ph_t = np.where(searching, read[:, 2], ph_t)
            accept_f = np.zeros(B, dtype=bool)
            want_soc = np.zeros(B, dtype=bool)
            for i in np.flatnonzero(searching):
                armijo[i] = K.is_armijo(ph_t[i], varphi[i], o.eta_phi,
                                        alpha[i], varphi_d[i])
                ftype = K.get_ftype(
                    K.filter_lane(st.filter, i), theta[i], th_t[i], varphi[i],
                    ph_t[i], bool(switching[i]), bool(armijo[i]),
                    st.theta_min[i], o.obj_max_inc, o.gamma_theta,
                    o.gamma_phi, p.has_constraints, eps,
                )
                accept_f[i] = ftype in (K.FTYPE_F, K.FTYPE_H)
                if accept_f[i]:
                    st.ftype[i] = ftype
                # SOC attempt: first backtrack only, theta increased
                want_soc[i] = (not accept_f[i] and not small[i]
                               and st.l_cnt[i] == 1 and th_t[i] >= theta[i])

            soc_ok = np.zeros(B, dtype=bool)
            alpha_soc = np.zeros(B)
            if want_soc.any():
                (soc_ok, alpha_soc, ft, x_s, obj_s,
                 c_s) = self.second_order_correction(
                    st, ctx, want_soc, alpha_max, theta, varphi, th_t,
                    varphi_d, switching)
                if soc_ok.any():
                    st.x_trial = self._sel(soc_ok, x_s, st.x_trial)
                    st.c_trial = self._sel(soc_ok, c_s, st.c_trial)
                    st.obj_val_trial = np.where(soc_ok, obj_s,
                                                st.obj_val_trial)
                    st.ftype = np.where(soc_ok, ft, st.ftype)

            for i in np.flatnonzero(searching):
                if accept_f[i] or small[i] or soc_ok[i]:
                    if soc_ok[i]:
                        alpha[i] = alpha_soc[i]
                    searching[i] = False
                    continue
                # rejection path (line_search.jl:79-97)
                alpha[i] = alpha[i] / 2.0
                if alpha[i] < alpha_min[i]:
                    st.k[i] += 1
                    code[i] = S.RESTORE
                    searching[i] = False
                    continue
                if alpha[i] * dnorm[i] < eps * 10:
                    st.restoration_fail_count[i] += 1
                    if st.restoration_fail_count[i] >= 4:
                        code[i] = (S.SOLVED_TO_ACCEPTABLE_LEVEL
                                   if st.acceptable_cnt[i] > 0
                                   else S.SEARCH_DIRECTION_BECOMES_TOO_SMALL)
                    else:
                        # second chance: reset the duals and the filter
                        second_chance[i] = True
                        st.k[i] += 1
                        code[i] = S.REGULAR
                    searching[i] = False
                    continue
                st.l_cnt[i] += 1
        st.alpha = np.where(lanes, alpha, st.alpha)
        st.alpha_z = np.where(lanes, alpha_z, st.alpha_z)

        if second_chance.any():
            st.y = self._sel(second_chance, torch.zeros_like(st.y), st.y)
            st.zl = self._sel(second_chance, self._bound_ones(lb, B), st.zl)
            st.zu = self._sel(second_chance, self._bound_ones(ub, B), st.zu)
            st.filter = K.filter_lanes(K.filter_reset, st.filter,
                                       second_chance, st.theta_max)
        stopped = lanes & (code != 0)
        st.status[stopped] = code[stopped]
        done = lanes & (code == 0)
        # filter-restart heuristic (line_search.jl:103-115): count
        # iterations that needed backtracking (l_cnt > 1 at acceptance)
        restart = np.zeros(B, dtype=bool)
        for i in np.flatnonzero(done):
            if st.l_cnt[i] > 1:
                cnt = st.unsuccessful_iterate[i] + 1
                if cnt >= 4:
                    tm = st.theta_max[i] / 10.0
                    if tm > th_t[i]:
                        st.theta_max[i] = tm
                        restart[i] = True
                    st.unsuccessful_iterate[i] = 0
                else:
                    st.unsuccessful_iterate[i] = cnt
            else:
                st.unsuccessful_iterate[i] = 0
        if restart.any():
            st.filter = K.filter_lanes(K.filter_reset, st.filter, restart,
                                       st.theta_max)
        # augment filter (line_search.jl:117-120)
        augment = done & ~(switching & armijo)
        if augment.any():
            st.filter = K.filter_lanes(
                lambda f, th, ph: K.filter_augment(f, th, ph, o.gamma_theta),
                st.filter, augment, th_t, ph_t)
        st.status[done] = int(S.LINESEARCH_SUCCEEDED)

    # ------------------------------------------------------------------
    # one batched step, and regular! — one masked iteration of the
    # REGULAR lanes
    # ------------------------------------------------------------------

    def step(self, st: BatchState) -> BatchState:
        """One step of every active lane (``batched_step``): the regular,
        restore and robust passes, each on the lanes whose status held its
        phase at the start of the step."""
        phase = [st.status == int(code)
                 for code in (S.REGULAR, S.RESTORE, S.ROBUST)]
        for run, on in zip((self.regular_step, self.restore_step,
                            self.robust_step), phase):
            if on.any():
                st = run(st, on)
        return st

    def regular_step(self, st: BatchState, act) -> BatchState:
        """One iteration of the REGULAR lanes in ``act``."""
        o, p = self.opts, self.prob
        lb, ub = self.lb, self.ub

        # Jacobian refresh (skipped at k == 0: evaluated in initialize)
        refresh = act & (st.k > 0)
        if not o.jacobian_constant and refresh.any():
            st.jac = self._sel(refresh, p.eval_jac(st.scal, st.x, st.theta),
                               st.jac)
            st.jac_cnt[refresh] += 1
        st.jacl = self._sel(act, self.kkt.jtprod(st.jac, st.y), st.jacl)

        sd = K.get_sd(st.y, st.zl, st.zu, lb, ub, p.m, p.nlb, p.nub, o.s_max)
        sc = K.get_sc(st.zl, st.zu, lb, ub, p.nlb, p.nub, o.s_max)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        sc, inf_pr, inf_du, inf_compl = torch.stack([
            sc,
            K.get_inf_pr(st.c),
            K.get_inf_du(st.f, st.zl, st.zu, st.jacl, sd),
            K.get_inf_compl(dl, du_, st.zl, st.zu, lb, ub, 0.0, sc),
        ], -1).cpu().numpy().T
        st.inf_pr = np.where(act, inf_pr, st.inf_pr)
        st.inf_du = np.where(act, inf_du, st.inf_du)
        st.inf_compl = np.where(act, inf_compl, st.inf_compl)

        # termination (solver.jl:239-246), lane by lane
        inf_total = np.maximum(np.maximum(inf_pr, inf_du), inf_compl)
        for i in np.flatnonzero(act):
            status = S.REGULAR
            acceptable = inf_total[i] <= o.acceptable_tol
            if acceptable and st.acceptable_cnt[i] >= o.acceptable_iter:
                status = S.SOLVED_TO_ACCEPTABLE_LEVEL
            if inf_total[i] >= o.diverging_iterates_tol:
                status = S.DIVERGING_ITERATES
            if st.k[i] >= o.max_iter:
                status = S.MAXIMUM_ITERATIONS_EXCEEDED
            if inf_total[i] <= o.tol:
                status = S.SOLVE_SUCCEEDED
            st.acceptable_cnt[i] = st.acceptable_cnt[i] + 1 if acceptable else 0
            st.status[i] = int(status)
        act = act & (st.status == int(S.REGULAR))
        if not act.any():
            return st

        # Hessian refresh
        refresh = act & (st.k > 0)
        if not o.hessian_constant and refresh.any():
            self._refresh_hessian(st, refresh)
        # (an adaptive rule's probing solves read st.ctx, the stale factor)
        self.update_barrier(st, sc, act)
        p_rhs = self._aug_rhs(st, st.c, st.mu)
        ctx, d, ok = self.inertia_correction(st, p_rhs, act)
        st.d = self._sel(act, d, st.d)
        st.p = self._sel(act, p_rhs, st.p)
        self._persist(st, ctx, act)
        # solver.jl:646-649: k += 1 before switching to robust restoration
        fail = act & ~ok
        st.status[fail] = int(S.ROBUST)
        st.k[fail] += 1
        st.rr_init_needed[fail] = True

        search = act & ok
        if not search.any():
            return st
        self.filter_line_search(st, ctx, d, search)
        resto = search & (st.status == int(S.RESTORE))
        if resto.any():
            # stash the backups and set soft restoration up
            # (solver.jl:300-322)
            dl, du_ = self.slacks(st.x, st.xl, st.xu)
            F = K.get_F(st.c, st.f, st.zl, st.zu, st.jacl, dl, du_, lb, ub,
                        self._t(st.mu)).cpu().numpy()
            st.soft_F = np.where(resto, F, st.soft_F)
            st.del_w[resto] = 0.0
            st.backup_x = self._sel(resto, st.x, st.backup_x)
            st.backup_y = self._sel(resto, st.y, st.backup_y)
            st.backup_c = self._sel(resto, st.c, st.backup_c)
            st.alpha_z[resto] = 0.0
            st.ftype[resto] = K.FTYPE_RESTORE
        acc = search & (st.status == int(S.LINESEARCH_SUCCEEDED))
        if not acc.any():
            return st
        mu_t = self._t(st.mu)
        x = st.x_trial
        y = st.y + self._t(st.alpha)[:, None] * d.y
        alpha_z = self._t(st.alpha_z)[:, None]
        zl = st.zl + alpha_z * d.zl
        zu = st.zu + alpha_z * d.zu
        xl, xu = K.adjust_boundary(x, st.xl, st.xu, lb, ub, mu_t)
        dl, du_ = K.slacks(x, xl, xu, lb, ub)
        zl = K.reset_bound_dual(zl, dl, lb, mu_t, o.kappa_sigma)
        zu = K.reset_bound_dual(zu, du_, ub, mu_t, o.kappa_sigma)
        f = p.eval_grad(st.scal, x, st.theta)
        st.x = self._sel(acc, x, st.x)
        st.y = self._sel(acc, y, st.y)
        st.zl = self._sel(acc, zl, st.zl)
        st.zu = self._sel(acc, zu, st.zu)
        st.xl = self._sel(acc, xl, st.xl)
        st.xu = self._sel(acc, xu, st.xu)
        st.c = self._sel(acc, st.c_trial, st.c)
        st.f = self._sel(acc, f, st.f)
        st.obj_val = np.where(acc, st.obj_val_trial, st.obj_val)
        st.grad_cnt[acc] += 1
        st.k[acc] += 1
        st.status[acc] = int(S.REGULAR)
        return st

    # ------------------------------------------------------------------
    # restore! — soft restoration, one masked iteration (solver.jl:300-411)
    # ------------------------------------------------------------------

    def _filter_ok(self, filt, lanes, theta, varphi):
        """Per lane of ``lanes``: (theta, varphi) acceptable to its filter."""
        ok = np.zeros(len(lanes), dtype=bool)
        for i in np.flatnonzero(lanes):
            ok[i] = K.is_filter_acceptable(K.filter_lane(filt, i), theta[i],
                                           varphi[i])
        return ok

    def restore_step(self, st: BatchState, act) -> BatchState:
        o, p = self.opts, self.prob
        lb, ub = self.lb, self.ub
        B = st.lanes
        mu_t = self._t(st.mu)
        d = st.d
        alpha_max, alpha_z = torch.stack([
            K.get_alpha_max(st.x, st.xl, st.xu, d.xp, self._t(st.tau), lb, ub),
            K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, self._t(st.tau), lb, ub),
        ], -1).cpu().numpy().T
        alpha = np.where(act, np.minimum(alpha_max, alpha_z), 0.0)
        a = self._t(alpha)[:, None]
        x = st.x + a * d.xp
        y = st.y + a * d.y
        zl = st.zl + a * d.zl
        zu = st.zu + a * d.zu
        c = self.eval_cons(st, x)
        f = p.eval_grad(st.scal, x, st.theta)
        obj = self.eval_obj(st, x)
        if not o.jacobian_constant:
            st.jac = self._sel(act, p.eval_jac(st.scal, x, st.theta), st.jac)
            st.jac_cnt[act] += 1
        jacl = self.kkt.jtprod(st.jac, y)
        st.con_cnt[act] += 1
        st.grad_cnt[act] += 1
        st.obj_cnt[act] += 1
        dl, du_ = self.slacks(x, st.xl, st.xu)
        obj, F_trial = torch.stack([
            obj.to(torch.float64),
            K.get_F(c, f, zl, zu, jacl, dl, du_, lb, ub, mu_t)], -1,
        ).cpu().numpy().T
        st.x, st.y = self._sel(act, x, st.x), self._sel(act, y, st.y)
        st.zl, st.zu = self._sel(act, zl, st.zl), self._sel(act, zu, st.zu)
        st.c, st.f = self._sel(act, c, st.c), self._sel(act, f, st.f)
        st.jacl = self._sel(act, jacl, st.jacl)
        st.obj_val = np.where(act, obj, st.obj_val)
        st.alpha = np.where(act, alpha, st.alpha)

        # revert to the backup iterate (solver.jl:362-367)
        revert = act & (F_trial > o.soft_resto_pderror_reduction_factor
                        * st.soft_F)
        if revert.any():
            st.x = self._sel(revert, st.backup_x, st.x)
            st.y = self._sel(revert, st.backup_y, st.y)
            st.c = self._sel(revert, st.backup_c, st.c)
            st.status[revert] = int(S.ROBUST)
            st.rr_init_needed[revert] = True
        go = act & ~revert
        if not go.any():
            return st

        xl, xu = K.adjust_boundary(st.x, st.xl, st.xu, lb, ub, mu_t)
        st.xl, st.xu = self._sel(go, xl, st.xl), self._sel(go, xu, st.xu)
        st.soft_F = np.where(go, F_trial, st.soft_F)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        sd, sc = self.single._sd_sc(st)
        theta, varphi, inf_pr, inf_du, inf_compl, icm = torch.stack([
            K.get_theta(st.c),
            K.get_varphi(self._t(st.obj_val), dl, du_, lb, ub, mu_t),
            *self.single._residuals(st, sd, sc),
            K.get_inf_compl(dl, du_, st.zl, st.zu, lb, ub, mu_t, sc),
        ], -1).cpu().numpy().T
        st.k[go] += 1
        back = go & self._filter_ok(st.filter, go, theta, varphi)
        st.status[back] = int(S.REGULAR)
        out = go & ~back & (st.k >= o.max_iter)
        st.status[out] = int(S.MAXIMUM_ITERATIONS_EXCEEDED)
        run = go & ~back & ~out
        if not run.any():
            return st

        st.t_cnt[run] += 1
        st.inf_pr = np.where(run, inf_pr, st.inf_pr)
        st.inf_du = np.where(run, inf_du, st.inf_du)
        st.inf_compl = np.where(run, inf_compl, st.inf_compl)
        st.inf_compl_mu = np.where(run, icm, st.inf_compl_mu)
        # the JAX package's original-NLP convergence check inside soft
        # restoration (see Kernel.restore_step)
        nlp_converged = np.maximum(np.maximum(inf_pr, inf_du),
                                   inf_compl) <= o.tol
        if not o.hessian_constant:
            self._refresh_hessian(st, run)
        p_rhs = self._aug_rhs(st, st.c, st.mu)
        ctx = self._factorize(st, np.zeros(B), np.zeros(B), run, None)
        self._persist(st, ctx, run)
        # restoration solves keep the exact refinement tolerance
        d, _, iters = self.kkt.solve_refine(ctx, p_rhs, mu=None, active=run)
        st.d = self._sel(run, d, st.d)
        st.p = self._sel(run, p_rhs, st.p)
        st.factorization_cnt[run] += 1
        st.backsolve_cnt[run] += iters[run]
        st.last_ir[run] = iters[run]
        st.ftype[run] = K.FTYPE_F
        st.status[run & nlp_converged] = int(S.SOLVE_SUCCEEDED)
        st.status[run & ~nlp_converged] = int(S.RESTORE)
        return st

    # ------------------------------------------------------------------
    # robust! — ℓ1-penalty restoration, one masked iteration
    # (solver.jl:413-545)
    # ------------------------------------------------------------------

    def _init_robust_restorer(self, st: BatchState, lanes) -> None:
        """initialize_robust_restorer! (restoration.jl:39-75) of the lanes
        in ``lanes``."""
        o = self.opts
        rho = o.rho
        R = st.RR
        c = st.c
        theta_ref, c_max = torch.stack([K.get_theta(c), K.get_inf_pr(c)],
                                       -1).cpu().numpy().T
        mu_R = np.maximum(st.mu, c_max)
        zeta = np.sqrt(mu_R)
        D_R, pp, nn, zp, zn = self.single._rr_slacks_init(st.x, c,
                                                          self._t(mu_R))
        obj_val_R = K.get_obj_val_R(pp, nn, D_R, st.x, st.x, rho,
                                    self._t(zeta)).cpu().numpy()

        def put(name, new):
            setattr(R, name, self._sel(lanes, new, getattr(R, name)))

        put("x_ref", st.x)
        put("D_R", D_R)
        put("nn", nn)
        put("pp", pp)
        put("zp", zp)
        put("zn", zn)
        put("f_R", torch.zeros_like(st.x))
        R.theta_ref = np.where(lanes, theta_ref, R.theta_ref)
        R.mu_R = np.where(lanes, mu_R, R.mu_R)
        R.tau_R = np.where(lanes, np.maximum(o.tau_min, 1.0 - mu_R), R.tau_R)
        R.zeta = np.where(lanes, zeta, R.zeta)
        R.obj_val_R = np.where(lanes, obj_val_R, R.obj_val_R)
        R.filter = K.filter_lanes(K.filter_reset, R.filter, lanes,
                                  st.theta_max)
        st.y = self._sel(lanes, torch.zeros_like(st.y), st.y)
        st.zl = self._sel(lanes, torch.where(
            self.lb, torch.clamp_max(st.zl, rho), 0.0), st.zl)
        st.zu = self._sel(lanes, torch.where(
            self.ub, torch.clamp_max(st.zu, rho), 0.0), st.zu)
        st.t_cnt[lanes] = 0
        st.del_w[lanes] = 0.0
        st.rr_init_needed[lanes] = False

    def _update_monotone_RR(self, st: BatchState, sc, act) -> None:
        """The restoration barrier's monotone decrease (barrier.jl:39-88)
        of the lanes in ``act``."""
        o = self.opts
        bo = o.barrier_options
        R = st.RR
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        sc_t = self._t(sc)
        mu_R, tau_R, zeta = R.mu_R.copy(), R.tau_R.copy(), R.zeta.copy()
        filt = R.filter
        loop = act.copy()
        while loop.any():
            icm = K.get_inf_compl_R(dl, du_, st.zl, st.zu, self.lb, self.ub,
                                    R.pp, R.zp, R.nn, R.zn, self._t(mu_R),
                                    sc_t).cpu().numpy()
            err = np.maximum(np.maximum(R.inf_pr_R, R.inf_du_R), icm)
            loop &= (mu_R >= o.mu_min) & (err <= o.barrier_tol_factor * mu_R)
            for i in np.flatnonzero(loop):
                mu_R[i] = K.get_mu(float(mu_R[i]), o.mu_min,
                                   bo.mu_linear_decrease_factor,
                                   bo.mu_superlinear_decrease_power, o.tol)
                tau_R[i] = max(o.tau_min, 1.0 - mu_R[i])
                zeta[i] = math.sqrt(mu_R[i])
            filt = K.filter_lanes(K.filter_reset, filt, loop, st.theta_max)
        R.mu_R, R.tau_R, R.zeta, R.filter = mu_R, tau_R, zeta, filt

    def filter_line_search_RR(self, st: BatchState, lanes) -> None:
        """The restoration problem's filter line search
        (line_search.jl:129-222) of every lane in ``lanes`` at once; sets
        each lane's trial point, alpha, ftype, RR filter and status as the
        single solve's ``filter_line_search_RR`` does."""
        o, p = self.opts, self.prob
        eps = self.eps
        lb, ub = self.lb, self.ub
        B = st.lanes
        R, d = st.RR, st.d
        mu_R, tau_R = self._t(R.mu_R), self._t(R.tau_R)
        zeta = self._t(R.zeta)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (theta_R, varphi_R, varphi_d_R, alpha_max, alpha_z,
         rel_norm) = torch.stack([
            K.get_theta_R(st.c, R.pp, R.nn),
            K.get_varphi_R(self._t(R.obj_val_R), dl, du_, lb, ub, R.pp, R.nn,
                           mu_R),
            K.get_varphi_d_R(R.f_R, dl, du_, lb, ub, d.xp, R.pp, R.nn, R.dpp,
                             R.dnn, mu_R, o.rho),
            K.get_alpha_max_R(st.x, st.xl, st.xu, d.xp, lb, ub, R.pp, R.dpp,
                              R.nn, R.dnn, tau_R),
            K.get_alpha_z_R(st.zl, st.zu, d.zl, d.zu, lb, ub, R.zp, R.dzp,
                            R.zn, R.dzn, tau_R),
            K.get_rel_search_norm(st.x, d.xp),
        ], -1).cpu().numpy().T
        alpha_min = np.array([K.get_alpha_min(
            theta_R[i], varphi_d_R[i], st.theta_min[i], o.gamma_theta,
            o.gamma_phi, o.alpha_min_frac, o.delta, o.s_theta, o.s_phi,
        ) for i in range(B)])
        small = rel_norm < 10 * eps
        switching = np.array([K.is_switching(
            varphi_d_R[i], alpha_max[i], o.s_phi, o.delta, theta_R[i],
            o.s_theta) for i in range(B)])

        st.l_cnt[lanes] = 1
        alpha = alpha_max.copy()
        code = np.zeros(B, dtype=np.int64)
        th_t = np.zeros(B)
        ph_t = np.zeros(B)
        armijo = np.zeros(B, dtype=bool)
        second_chance = np.zeros(B, dtype=bool)
        searching = lanes.copy()
        while searching.any():
            a = self._t(alpha)[:, None]
            x_t = st.x + a * d.xp
            pp_t = R.pp + a * R.dpp
            nn_t = R.nn + a * R.dnn
            obj_R_t = K.get_obj_val_R(pp_t, nn_t, R.D_R, x_t, R.x_ref, o.rho,
                                      zeta)
            c_t = self.eval_cons(st, x_t)
            st.con_cnt[searching] += 1
            dl_t, du_t = self.slacks(x_t, st.xl, st.xu)
            read = torch.stack([
                obj_R_t, K.get_theta_R(c_t, pp_t, nn_t),
                K.get_varphi_R(obj_R_t, dl_t, du_t, lb, ub, pp_t, nn_t, mu_R),
            ], -1).cpu().numpy()
            st.x_trial = self._sel(searching, x_t, st.x_trial)
            st.c_trial = self._sel(searching, c_t, st.c_trial)
            R.pp_trial = self._sel(searching, pp_t, R.pp_trial)
            R.nn_trial = self._sel(searching, nn_t, R.nn_trial)
            R.obj_val_R_trial = np.where(searching, read[:, 0],
                                         R.obj_val_R_trial)
            th_t = np.where(searching, read[:, 1], th_t)
            ph_t = np.where(searching, read[:, 2], ph_t)
            for i in np.flatnonzero(searching):
                armijo[i] = K.is_armijo(ph_t[i], varphi_R[i], o.eta_phi,
                                        alpha[i], varphi_d_R[i])
                ftype = K.get_ftype(
                    K.filter_lane(R.filter, i), theta_R[i], th_t[i],
                    varphi_R[i], ph_t[i], bool(switching[i]),
                    bool(armijo[i]), st.theta_min[i], o.obj_max_inc,
                    o.gamma_theta, o.gamma_phi, p.has_constraints, eps,
                )
                accept_f = ftype in (K.FTYPE_F, K.FTYPE_H)
                if accept_f:
                    st.ftype[i] = ftype
                if accept_f or small[i]:
                    searching[i] = False
                    continue
                alpha[i] = alpha[i] / 2.0
                if alpha[i] < alpha_min[i]:
                    st.restoration_fail_count[i] += 1
                    if st.restoration_fail_count[i] >= 4:
                        code[i] = S.RESTORATION_FAILED
                    else:
                        # second chance: reset the duals and the filter
                        second_chance[i] = True
                        st.k[i] += 1
                        st.t_cnt[i] += 1
                        code[i] = S.REGULAR
                    searching[i] = False
                    continue
                if alpha[i] < eps * 10:
                    code[i] = (S.SOLVED_TO_ACCEPTABLE_LEVEL
                               if st.acceptable_cnt[i] > 0
                               else S.SEARCH_DIRECTION_BECOMES_TOO_SMALL)
                    searching[i] = False
                    continue
                st.l_cnt[i] += 1
        st.alpha = np.where(lanes, alpha, st.alpha)
        st.alpha_z = np.where(lanes, alpha_z, st.alpha_z)

        if second_chance.any():
            st.y = self._sel(second_chance, torch.zeros_like(st.y), st.y)
            st.zl = self._sel(second_chance, self._bound_ones(lb, B), st.zl)
            st.zu = self._sel(second_chance, self._bound_ones(ub, B), st.zu)
            st.filter = K.filter_lanes(K.filter_reset, st.filter,
                                       second_chance, st.theta_max)
        stopped = lanes & (code != 0)
        st.status[stopped] = code[stopped]
        done = lanes & (code == 0)
        augment = done & ~(switching & armijo)
        if augment.any():
            R.filter = K.filter_lanes(
                lambda f, th, ph: K.filter_augment(f, th, ph, o.gamma_theta),
                R.filter, augment, th_t, ph_t)
        st.status[done] = int(S.LINESEARCH_SUCCEEDED)

    def robust_step(self, st: BatchState, act) -> BatchState:
        o, p = self.opts, self.prob
        lb, ub = self.lb, self.ub
        B = st.lanes
        init = act & st.rr_init_needed
        if init.any():
            self._init_robust_restorer(st, init)
        if not o.jacobian_constant:
            st.jac = self._sel(act, p.eval_jac(st.scal, st.x, st.theta),
                               st.jac)
            st.jac_cnt[act] += 1
        st.jacl = self._sel(act, self.kkt.jtprod(st.jac, st.y), st.jacl)

        R = st.RR
        sd, sc = self.single._sd_sc(st)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        (sc, inf_pr, inf_du, inf_compl, inf_pr_R, inf_du_R,
         inf_compl_R) = torch.stack([
            sc, *self.single._residuals(st, sd, sc),
            K.get_inf_pr_R(st.c, R.pp, R.nn),
            K.get_inf_du_R(R.f_R, st.y, st.zl, st.zu, st.jacl, R.zp, R.zn,
                           o.rho, sd),
            K.get_inf_compl_R(dl, du_, st.zl, st.zu, lb, ub, R.pp, R.zp, R.nn,
                              R.zn, 0.0, sc),
        ], -1).cpu().numpy().T
        st.inf_pr = np.where(act, inf_pr, st.inf_pr)
        st.inf_du = np.where(act, inf_du, st.inf_du)
        st.inf_compl = np.where(act, inf_compl, st.inf_compl)
        R.inf_pr_R = np.where(act, inf_pr_R, R.inf_pr_R)
        R.inf_du_R = np.where(act, inf_du_R, R.inf_du_R)
        R.inf_compl_R = np.where(act, inf_compl_R, R.inf_compl_R)

        status = np.full(B, int(S.ROBUST))
        status[st.k >= o.max_iter] = int(S.MAXIMUM_ITERATIONS_EXCEEDED)
        # the JAX package's original-NLP convergence check inside robust
        # restoration (see Kernel.robust_step)
        status[np.maximum(np.maximum(inf_pr, inf_du), inf_compl)
               <= o.tol] = int(S.SOLVE_SUCCEEDED)
        st.status[act] = status[act]

        # the restoration problem is solved: locally infeasible, or
        # least-squares multipliers decide (see Kernel.robust_step)
        solved = act & (status == int(S.ROBUST)) & (np.maximum(
            np.maximum(inf_pr_R, inf_du_R), inf_compl_R) <= o.tol)
        st.status[solved & (inf_pr > o.tol)] = int(
            S.INFEASIBLE_PROBLEM_DETECTED)
        recover = solved & (inf_pr <= o.tol)
        if recover.any():
            y_old, jacl_old = st.y, st.jacl
            y_new, _ = self._least_squares_duals(st, recover)
            st.y = self._sel(recover, y_new, st.y)
            st.jacl = self._sel(recover, self.kkt.jtprod(st.jac, y_new),
                                st.jacl)
            res = torch.stack(self.single._residuals(
                st, *self.single._sd_sc(st)), -1).cpu().numpy()
            good = recover & (res.max(1) <= o.tol)
            st.inf_pr = np.where(good, res[:, 0], st.inf_pr)
            st.inf_du = np.where(good, res[:, 1], st.inf_du)
            st.inf_compl = np.where(good, res[:, 2], st.inf_compl)
            st.status[good] = int(S.SOLVE_SUCCEEDED)
            bad = recover & ~good
            st.y = self._sel(bad, y_old, st.y)
            st.jacl = self._sel(bad, jacl_old, st.jacl)
            st.status[bad] = int(S.RESTORATION_FAILED)
        run = act & (status == int(S.ROBUST)) & ~solved
        if not run.any():
            return st

        self._update_monotone_RR(st, sc, run)
        if not o.hessian_constant:
            self._refresh_hessian(st, run, is_resto=True)
        p_rhs = self.single._aug_rhs_RR(st, self._t(R.mu_R))
        st.p = self._sel(run, p_rhs, st.p)
        ctx, d, ok = self.inertia_correction(st, p_rhs, run, rr=True)
        st.d = self._sel(run, d, st.d)
        self._persist(st, ctx, run)
        st.status[run & ~ok] = int(S.RESTORATION_FAILED)
        go = run & ok
        if not go.any():
            return st

        mu_R = self._t(R.mu_R)
        dpp, dnn, dzp, dzn = self.single._finish_aug_solve_RR(R, st.y, d.y,
                                                              mu_R)
        R.dpp, R.dnn = self._sel(go, dpp, R.dpp), self._sel(go, dnn, R.dnn)
        R.dzp, R.dzn = self._sel(go, dzp, R.dzp), self._sel(go, dzn, R.dzn)
        self.filter_line_search_RR(st, go)
        acc = go & (st.status == int(S.LINESEARCH_SUCCEEDED))
        if not acc.any():
            return st

        alpha = self._t(st.alpha)[:, None]
        alpha_z = self._t(st.alpha_z)[:, None]
        x = st.x_trial
        y = st.y + alpha * d.y
        zl = st.zl + alpha_z * d.zl
        zu = st.zu + alpha_z * d.zu
        zp = R.zp + alpha_z * R.dzp
        zn = R.zn + alpha_z * R.dzn
        f_R, zl, zu, zp, zn = self.single._accept_RR(
            R, x, st.xl, st.xu, zl, zu, zp, zn, mu_R, self._t(R.zeta))
        pp, nn = R.pp_trial, R.nn_trial
        mu_t = self._t(st.mu)
        xl, xu = K.adjust_boundary(x, st.xl, st.xu, lb, ub, mu_t)
        obj = self.eval_obj(st, x)
        f = p.eval_grad(st.scal, x, st.theta)
        R.f_R = self._sel(acc, f_R, R.f_R)
        R.zp, R.zn = self._sel(acc, zp, R.zp), self._sel(acc, zn, R.zn)
        R.pp, R.nn = self._sel(acc, pp, R.pp), self._sel(acc, nn, R.nn)
        R.obj_val_R = np.where(acc, R.obj_val_R_trial, R.obj_val_R)
        st.zl, st.zu = self._sel(acc, zl, st.zl), self._sel(acc, zu, st.zu)
        st.xl, st.xu = self._sel(acc, xl, st.xl), self._sel(acc, xu, st.xu)
        st.f = self._sel(acc, f, st.f)
        st.x, st.y = self._sel(acc, x, st.x), self._sel(acc, y, st.y)
        st.c = self._sel(acc, st.c_trial, st.c)
        st.obj_cnt[acc] += 1
        st.grad_cnt[acc] += 1
        # exit check (solver.jl:509-536)
        dl, du_ = self.slacks(st.x, st.xl, st.xu)
        obj, theta, varphi = torch.stack([
            obj.to(torch.float64), K.get_theta(st.c),
            K.get_varphi(obj, dl, du_, lb, ub, mu_t)], -1).cpu().numpy().T
        st.obj_val = np.where(acc, obj, st.obj_val)
        st.k[acc] += 1
        st.t_cnt[acc] += 1
        back = acc & self._filter_ok(st.filter, acc, theta, varphi) & (
            theta <= o.required_infeasibility_reduction * R.theta_ref)
        if back.any():
            y_ls, ls_ctx = self._least_squares_duals(st, back)
            st.y = self._sel(back, y_ls, st.y)
            self._persist(st, ls_ctx, back)
        st.status[back] = int(S.REGULAR)
        st.status[acc & ~back] = int(S.ROBUST)
        return st
