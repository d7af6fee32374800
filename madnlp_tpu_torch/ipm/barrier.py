"""Adaptive barrier updates — port of ``madnlp_tpu/ipm/barrier.py``: the
quality-function rule (Nocedal, Wächter & Waltz 2009, §4) and the LOQO
rule, with the free/monotone globalization switch (barrier.jl:94-316).

The quality function's two probing solves reuse the *previous* iteration's
factorization without refinement (barrier.jl:273-283): ``state.ctx``, the
KKT context :class:`.step.Kernel` keeps from its last factorization under an
adaptive rule.  The golden-section search runs on the host over host
floats: each evaluation of the quality function reads one scalar.

The ``*_lanes`` forms are the same rules over the lane axis of
``solve_batch`` (:class:`.batch.BatchKernel`), each on the lanes of a numpy
mask: per-lane modes, μ and filters; the probing solves run through the
batched backsolve (K4) on the free-mode lanes only, each on its lane's
persisted factor; the golden-section search gives each lane its own
bracket and "done" mask, and each of its steps evaluates the quality
function of every lane at once (one ``(B, 3)`` read).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kkt.vec import KKTVec
from . import kernels as K


def _check_progress(kern, st, sc) -> bool:
    """barrier.jl:104-116."""
    o = kern.opts
    if not o.barrier_options.globalization:
        return True
    kappa_1, kappa_2 = 1e-5, 1.0
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    theta, varphi = torch.stack([
        K.get_theta(st.c),
        K.get_varphi(st.obj_val, dl, du_, kern.lb, kern.ub, st.mu)]).tolist()
    kkt_error = max(st.inf_pr, st.inf_du, st.inf_compl)
    delta = kappa_1 * min(kappa_2, kkt_error)
    return K.is_filter_acceptable(st.filter, theta + delta, varphi + delta)


def _avg_compl(kern, st) -> float:
    p = kern.prob
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    return float(K.get_average_complementarity(
        dl, du_, st.zl, st.zu, kern.lb, kern.ub, p.nlb, p.nub))


def _quality_function(kern, st, sigma, step_aff, step_cen, res_primal,
                      res_dual) -> float:
    """Linear quality function qL (barrier.jl:152-201)."""
    p = kern.prob
    d = step_aff.axpy(sigma, step_cen)
    alpha_pr, alpha_du = torch.stack([
        K.get_alpha_max(st.x, st.xl, st.xu, d.xp, st.tau, kern.lb, kern.ub),
        K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, st.tau, kern.lb, kern.ub),
    ]).tolist()
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    cc_lb = torch.where(
        kern.lb, ((dl + alpha_pr * d.xp) * (st.zl + alpha_du * d.zl)) ** 2,
        0.0).sum()
    cc_ub = torch.where(
        kern.ub, ((du_ - alpha_pr * d.xp) * (st.zu + alpha_du * d.zu)) ** 2,
        0.0).sum()
    inf_pr = ((1.0 - alpha_pr) ** 2 * res_primal ** 2 / p.m if p.m > 0
              else 0.0)
    inf_du = (1.0 - alpha_du) ** 2 * res_dual ** 2 / max(p.nw, 1)
    inf_compl = float(cc_lb + cc_ub) / max(p.nlb + p.nub, 1)
    return inf_du + inf_pr + inf_compl


def _adaptive_mu_quality(kern, st, sc) -> float:
    """barrier.jl:260-302, with Ipopt's interval-restriction heuristics."""
    o = kern.opts
    bo = o.barrier_options
    p = kern.prob
    if p.nlb + p.nub == 0:
        return o.mu_min

    # affine step (μ = 0, no κ_d perturbation)
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    px = -st.f + st.zl - st.zu - st.jacl
    rhs_aff = KKTVec(
        xp=px,
        y=-st.c,
        zl=torch.where(kern.lb, -dl * st.zl, 0.0),
        zu=torch.where(kern.ub, du_ * st.zu, 0.0),
    )
    res_primal, res_dual = torch.stack([
        torch.linalg.vector_norm(rhs_aff.y) if p.m else px.new_zeros(()),
        torch.linalg.vector_norm(rhs_aff.xp)]).tolist()
    step_aff = kern.kkt.solve(st.ctx, rhs_aff)

    mu_avg = _avg_compl(kern, st)
    # centering step
    px_c = K.dual_inf_perturbation(torch.zeros_like(px), kern.llb, kern.uub,
                                   mu_avg, o.kappa_d)
    rhs_cen = KKTVec(
        xp=px_c,
        y=torch.zeros_like(st.c),
        zl=torch.where(kern.lb, mu_avg, 0.0),
        zu=torch.where(kern.ub, -mu_avg, 0.0),
    )
    step_cen = kern.kkt.solve(st.ctx, rhs_cen)

    def qf(sigma):
        return _quality_function(kern, st, sigma, step_aff, step_cen,
                                 res_primal, res_dual)

    phi1 = qf(1.0)
    sigma_1m = 1.0 - 1e-4
    phi1m = qf(sigma_1m)
    if phi1m > phi1:
        sigma_min = 1.0
        sigma_max = min(bo.sigma_max, bo.mu_max / mu_avg)
    else:
        sigma_min = max(bo.sigma_min, o.mu_min / mu_avg)
        sigma_max = min(max(sigma_min, sigma_1m), bo.mu_max / mu_avg)

    # golden-section search (barrier.jl:205-246)
    gfac = 0.5 * (3.0 - math.sqrt(5.0))
    s1, s2 = sigma_min, sigma_max
    p1, p2 = qf(s1), qf(s2)
    s1_in, s2_in, p1_in, p2_in = s1, s2, p1, p2
    m1 = s1 + gfac * (s2 - s1)
    m2 = s1 + (1.0 - gfac) * (s2 - s1)
    pm1, pm2 = qf(m1), qf(m2)
    for _ in range(bo.max_gs_iter):
        if pm1 > pm2:
            s1 = m1
            m1 = m2
            m2 = s1 + (1.0 - gfac) * (s2 - s1)
            pm1, pm2 = pm2, qf(m2)
        else:
            s2 = m2
            m2 = m1
            m1 = s1 + gfac * (s2 - s1)
            pm1, pm2 = qf(m1), pm1
        if s2 - s1 < bo.sigma_tol * s2:
            break
    sigma = m1 if pm1 < pm2 else m2
    # a NaN quality (a probe through a zero factor) propagates, as in
    # jnp.minimum
    phi = math.nan if math.isnan(pm1) or math.isnan(pm2) else min(pm1, pm2)
    # fall back to the input endpoints when the search didn't converge
    if s2 == s2_in and p2_in < phi:
        sigma = s2_in
    if s1 == s1_in and p1_in < phi:
        sigma = s1_in
    return min(max(sigma * mu_avg, o.mu_min), bo.mu_max)


def _adaptive_mu_loqo(kern, st, sc) -> float:
    """barrier.jl:304-316."""
    o = kern.opts
    bo = o.barrier_options
    p = kern.prob
    if p.nlb + p.nub == 0:
        return o.mu_min
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    mu_avg = _avg_compl(kern, st)
    min_cc = float(K.get_min_complementarity(dl, du_, st.zl, st.zu, kern.lb,
                                             kern.ub))
    xi = min_cc / mu_avg
    sigma = bo.gamma * min((1.0 - bo.r) * (1.0 - xi) / xi, 2.0) ** 3
    return min(max(sigma * mu_avg, o.mu_min), bo.mu_max)


def update_barrier_adaptive(kern, st, sc, rule: str):
    """barrier.jl:118-149: the free/monotone globalization switch, then the
    adaptive μ in free mode; updates ``st`` in place."""
    o = kern.opts
    old_mu = st.mu
    progress = _check_progress(kern, st, sc)
    if st.barrier_free_mode:
        if not progress:
            st.barrier_free_mode = False
            st.mu = min(max(0.8 * _avg_compl(kern, st), o.mu_min),
                        o.barrier_options.mu_max)
    elif progress:
        st.barrier_free_mode = True
    else:
        kern.update_barrier_monotone(st, sc)
    if st.barrier_free_mode:
        st.mu = (_adaptive_mu_quality(kern, st, sc)
                 if rule == "quality_function"
                 else _adaptive_mu_loqo(kern, st, sc))
    # τ and the filter reset when μ moved (barrier.jl:143-148)
    if st.mu != old_mu:
        st.tau = K.get_tau(st.mu, o.tau_min)
        st.filter = K.filter_reset(st.filter, st.theta_max)
    # keep inf_compl_mu coherent for printing and the monotone checks
    dl, du_ = kern.slacks(st.x, st.xl, st.xu)
    st.inf_compl_mu = float(K.get_inf_compl(dl, du_, st.zl, st.zu, kern.lb,
                                            kern.ub, st.mu, sc))
    return st


# -- over a lane axis (solve_batch) ------------------------------------------


def _check_progress_lanes(bk, st, lanes) -> np.ndarray:
    """:func:`_check_progress` of each lane in ``lanes``."""
    o = bk.opts
    if not o.barrier_options.globalization:
        return lanes.copy()
    kappa_1, kappa_2 = 1e-5, 1.0
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    theta, varphi = torch.stack([
        K.get_theta(st.c),
        K.get_varphi(bk._t(st.obj_val), dl, du_, bk.lb, bk.ub,
                     bk._t(st.mu))]).cpu().numpy()
    kkt_error = np.maximum(np.maximum(st.inf_pr, st.inf_du), st.inf_compl)
    delta = kappa_1 * np.minimum(kappa_2, kkt_error)
    ok = np.zeros(len(lanes), dtype=bool)
    for i in np.flatnonzero(lanes):
        ok[i] = K.is_filter_acceptable(K.filter_lane(st.filter, i),
                                       theta[i] + delta[i],
                                       varphi[i] + delta[i])
    return ok


def _avg_compl_lanes(bk, st) -> np.ndarray:
    p = bk.prob
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    return K.get_average_complementarity(
        dl, du_, st.zl, st.zu, bk.lb, bk.ub, p.nlb, p.nub).cpu().numpy()


def _quality_function_lanes(bk, st, sigma, step_aff, step_cen, res_primal,
                            res_dual) -> np.ndarray:
    """:func:`_quality_function` of every lane at its own ``sigma`` (B,)."""
    p = bk.prob
    d = step_aff.axpy(bk._t(sigma)[:, None], step_cen)
    tau = bk._t(st.tau)
    alpha_pr = K.get_alpha_max(st.x, st.xl, st.xu, d.xp, tau, bk.lb, bk.ub)
    alpha_du = K.get_alpha_z(st.zl, st.zu, d.zl, d.zu, tau, bk.lb, bk.ub)
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    a_pr, a_du = alpha_pr[:, None], alpha_du[:, None]
    cc_lb = torch.where(
        bk.lb, ((dl + a_pr * d.xp) * (st.zl + a_du * d.zl)) ** 2, 0.0).sum(-1)
    cc_ub = torch.where(
        bk.ub, ((du_ - a_pr * d.xp) * (st.zu + a_du * d.zu)) ** 2,
        0.0).sum(-1)
    alpha_pr, alpha_du, cc = torch.stack(
        [alpha_pr, alpha_du, cc_lb + cc_ub]).cpu().numpy()
    inf_pr = ((1.0 - alpha_pr) ** 2 * res_primal ** 2 / p.m if p.m > 0
              else np.zeros_like(alpha_pr))
    inf_du = (1.0 - alpha_du) ** 2 * res_dual ** 2 / max(p.nw, 1)
    inf_compl = cc / max(p.nlb + p.nub, 1)
    return inf_du + inf_pr + inf_compl


def _adaptive_mu_quality_lanes(bk, st, lanes, mu_avg) -> np.ndarray:
    """:func:`_adaptive_mu_quality` of each lane in ``lanes``: the two
    probing solves through the batched backsolve on those lanes, then the
    golden-section search with a bracket per lane.  ``mu_avg``: each
    lane's average complementarity.  Returns μ (B,) (the other lanes'
    entries are not used)."""
    o = bk.opts
    bo = o.barrier_options
    p = bk.prob
    if p.nlb + p.nub == 0:
        return np.full(len(lanes), o.mu_min)

    # affine step (μ = 0, no κ_d perturbation)
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    px = -st.f + st.zl - st.zu - st.jacl
    rhs_aff = KKTVec(
        xp=px,
        y=-st.c,
        zl=torch.where(bk.lb, -dl * st.zl, 0.0),
        zu=torch.where(bk.ub, du_ * st.zu, 0.0),
    )
    res_primal, res_dual = torch.stack([
        torch.linalg.vector_norm(rhs_aff.y, dim=-1) if p.m
        else px.new_zeros(px.shape[0]),
        torch.linalg.vector_norm(rhs_aff.xp, dim=-1)]).cpu().numpy()
    step_aff = bk.kkt.solve(st.ctx, rhs_aff, lanes)

    # centering step
    mu_c = bk._t(mu_avg)
    px_c = K.dual_inf_perturbation(torch.zeros_like(px), bk.llb, bk.uub,
                                   mu_c, o.kappa_d)
    mu_c = mu_c[:, None]
    rhs_cen = KKTVec(
        xp=px_c,
        y=torch.zeros_like(st.c),
        zl=torch.where(bk.lb, mu_c, 0.0),
        zu=torch.where(bk.ub, -mu_c, 0.0),
    )
    step_cen = bk.kkt.solve(st.ctx, rhs_cen, lanes)

    def qf(sigma):
        return _quality_function_lanes(bk, st, sigma, step_aff, step_cen,
                                       res_primal, res_dual)

    B = len(lanes)
    with np.errstate(divide="ignore", invalid="ignore"):
        phi1 = qf(np.ones(B))
        sigma_1m = 1.0 - 1e-4
        phi1m = qf(np.full(B, sigma_1m))
        wide = phi1m > phi1
        lo = np.maximum(bo.sigma_min, o.mu_min / mu_avg)
        sigma_min = np.where(wide, 1.0, lo)
        sigma_max = np.where(
            wide, np.minimum(bo.sigma_max, bo.mu_max / mu_avg),
            np.minimum(np.maximum(lo, sigma_1m), bo.mu_max / mu_avg))

        # golden-section search (barrier.jl:205-246), a bracket per lane
        gfac = 0.5 * (3.0 - math.sqrt(5.0))
        s1, s2 = sigma_min, sigma_max
        p1, p2 = qf(s1), qf(s2)
        s1_in, s2_in, p1_in, p2_in = s1, s2, p1, p2
        m1 = s1 + gfac * (s2 - s1)
        m2 = s1 + (1.0 - gfac) * (s2 - s1)
        pm1, pm2 = qf(m1), qf(m2)
        run = np.asarray(lanes, dtype=bool).copy()
        for _ in range(bo.max_gs_iter):
            if not run.any():
                break
            right = run & (pm1 > pm2)
            left = run & ~(pm1 > pm2)
            s1n = np.where(right, m1, s1)
            s2n = np.where(left, m2, s2)
            m1n = np.where(right, m2,
                           np.where(left, s1 + gfac * (s2n - s1), m1))
            m2n = np.where(right, s1n + (1.0 - gfac) * (s2 - s1n),
                           np.where(left, m1, m2))
            q = qf(np.where(right, m2n, m1n))
            pm1, pm2 = (np.where(right, pm2, np.where(left, q, pm1)),
                        np.where(right, q, np.where(left, pm1, pm2)))
            s1, s2, m1, m2 = s1n, s2n, m1n, m2n
            run &= ~(s2 - s1 < bo.sigma_tol * s2)
        sigma = np.where(pm1 < pm2, m1, m2)
        # a NaN quality (a probe through a zero factor) propagates, as in
        # jnp.minimum
        phi = np.minimum(pm1, pm2)
        # fall back to the input endpoints when the search didn't converge
        sigma = np.where((s2 == s2_in) & (p2_in < phi), s2_in, sigma)
        sigma = np.where((s1 == s1_in) & (p1_in < phi), s1_in, sigma)
        return np.minimum(np.maximum(sigma * mu_avg, o.mu_min), bo.mu_max)


def _adaptive_mu_loqo_lanes(bk, st, mu_avg) -> np.ndarray:
    """:func:`_adaptive_mu_loqo` of every lane."""
    o = bk.opts
    bo = o.barrier_options
    p = bk.prob
    if p.nlb + p.nub == 0:
        return np.full(len(mu_avg), o.mu_min)
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    min_cc = K.get_min_complementarity(dl, du_, st.zl, st.zu, bk.lb,
                                       bk.ub).cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = min_cc / mu_avg
        sigma = bo.gamma * np.minimum((1.0 - bo.r) * (1.0 - xi) / xi,
                                      2.0) ** 3
    return np.minimum(np.maximum(sigma * mu_avg, o.mu_min), bo.mu_max)


def update_barrier_adaptive_lanes(bk, st, sc, act, rule: str) -> None:
    """:func:`update_barrier_adaptive` of the lanes in ``act`` (numpy bool
    (B,)): each lane's free/monotone switch, the monotone decrease on the
    lanes that stay monotone, the adaptive μ on the free-mode lanes;
    updates ``st`` in place."""
    o = bk.opts
    old_mu = st.mu.copy()
    progress = _check_progress_lanes(bk, st, act)
    free = st.barrier_free_mode.copy()
    mu_avg = _avg_compl_lanes(bk, st)
    leave = act & free & ~progress
    st.mu = np.where(leave, np.minimum(np.maximum(0.8 * mu_avg, o.mu_min),
                                       o.barrier_options.mu_max), st.mu)
    mono = act & ~free & ~progress
    if mono.any():
        bk.update_barrier_monotone(st, sc, mono)
    # a lane leaves free mode without progress and (re)enters it with it
    free = np.where(act, progress, free)
    st.barrier_free_mode = free
    on = act & free
    if on.any():
        mu = (_adaptive_mu_quality_lanes(bk, st, on, mu_avg)
              if rule == "quality_function"
              else _adaptive_mu_loqo_lanes(bk, st, mu_avg))
        st.mu = np.where(on, mu, st.mu)
    # τ and the filter reset when μ moved (barrier.jl:143-148)
    moved = act & (st.mu != old_mu)
    st.tau = np.where(moved, [K.get_tau(float(m), o.tau_min) for m in st.mu],
                      st.tau)
    st.filter = K.filter_lanes(K.filter_reset, st.filter, moved,
                               st.theta_max)
    # keep inf_compl_mu coherent for printing and the monotone checks
    dl, du_ = bk.slacks(st.x, st.xl, st.xu)
    icm = K.get_inf_compl(dl, du_, st.zl, st.zu, bk.lb, bk.ub, bk._t(st.mu),
                          bk._t(sc)).cpu().numpy()
    st.inf_compl_mu = np.where(act, icm, st.inf_compl_mu)
