"""Adaptive barrier updates — port of ``madnlp_tpu/ipm/barrier.py``: the
quality-function rule (Nocedal, Wächter & Waltz 2009, §4) and the LOQO
rule, with the free/monotone globalization switch (barrier.jl:94-316).

The quality function's two probing solves reuse the *previous* iteration's
factorization without refinement (barrier.jl:273-283): ``state.ctx``, the
KKT context :class:`.step.Kernel` keeps from its last factorization under an
adaptive rule.  The golden-section search runs on the host over host
floats: each evaluation of the quality function reads one scalar.
"""

from __future__ import annotations

import math

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
