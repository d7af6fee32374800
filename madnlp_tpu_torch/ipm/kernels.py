"""IPM math kernels — port of ``madnlp_tpu/ipm/kernels.py``, the soft and
robust restoration kernels (``get_F`` … ``populate_RR_nn``) included.

Vector kernels are masked, fully vectorised torch functions returning
tensors, read on the host by the caller.  They broadcast over a leading
lane axis: vectors are ``(n,)`` for one solve or ``(B, n)`` for a batch,
reductions run over the last axis (0-d or ``(B,)`` results), and a
per-lane scalar argument (μ, τ, the objective) is a host float or a
``(B,)`` tensor.  Scalar formulas (barrier schedule, line-search
predicates) take and return host floats: the port's iteration runs its
control flow on the host, so these never touch the device; a batch calls
them lane by lane.  The filter is a small host-side table, ``(cap,)`` or
``(B, cap)``.

Conventions (as in the JAX package):

* ``dl = x - xl`` (> 0 in the interior) where ``lb_mask``, else 1.
* ``du = xu - x`` (> 0) where ``ub_mask``, else 1.
* ``zl``/``zu`` are full-length with zeros off-mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INF = math.inf


def as_col(s):
    """A per-lane scalar against the vectors it scales: a ``(B,)`` tensor
    becomes ``(B, 1)``; a host float stays as it is."""
    return s[..., None] if torch.is_tensor(s) else s


def _empty_reduce(v, init):
    return torch.full(v.shape[:-1], init, dtype=torch.float64, device=v.device)


def slacks(x, xl, xu, lb_mask, ub_mask):
    """Masked distances to bounds (safe off-mask)."""
    dl = torch.where(lb_mask, x - xl, 1.0)
    du = torch.where(ub_mask, xu - x, 1.0)
    return dl, du


def _msum(v, mask):
    return torch.where(mask, v, 0.0).sum(-1)


def _mmax(v, mask, init=0.0):
    if not v.shape[-1]:
        return _empty_reduce(v, init)
    return torch.where(mask, v, init).amax(-1)


def _mmin(v, mask, init=INF):
    if not v.shape[-1]:
        return _empty_reduce(v, init)
    return torch.where(mask, v, init).amin(-1)


def _amax(v):
    return v.abs().amax(-1) if v.shape[-1] else _empty_reduce(v, 0.0)


# -- barrier function --------------------------------------------------------


def get_varphi(obj_val, dl, du, lb_mask, ub_mask, mu):
    """φ = f - μ Σ log(dl) - μ Σ log(du); +Inf outside the interior
    (kernels.jl:263-281)."""
    bad = (lb_mask & (dl <= 0)).any(-1) | (ub_mask & (du <= 0)).any(-1)
    safe_l = torch.where(lb_mask & (dl > 0), dl, 1.0)
    safe_u = torch.where(ub_mask & (du > 0), du, 1.0)
    val = (obj_val - mu * torch.log(safe_l).sum(-1)
           - mu * torch.log(safe_u).sum(-1))
    return torch.where(bad, INF, val)


def get_varphi_d(f, dl, du, lb_mask, ub_mask, dx, mu):
    """Directional derivative of φ (kernels.jl:341-354)."""
    mu = as_col(mu)
    term = (
        f
        - torch.where(lb_mask, mu / dl, 0.0)
        + torch.where(ub_mask, mu / du, 0.0)
    )
    return _dot(term, dx)


def _dot(a, b):
    """Inner product over the last axis."""
    if a.ndim == 1:
        return torch.dot(a, b)
    return (a * b).sum(-1)


# -- residuals ---------------------------------------------------------------


def get_inf_pr(c):
    return _amax(c)


def get_theta(c):
    return c.abs().sum(-1)


def get_inf_du(f, zl, zu, jacl, sd):
    return _amax(f - zl + zu + jacl) / sd


def get_inf_compl(dl, du, zl, zu, lb_mask, ub_mask, mu, sc):
    mu = as_col(mu)
    a = _mmax(torch.abs(dl * zl - mu), lb_mask)
    b = _mmax(torch.abs(du * zu - mu), ub_mask)
    return torch.maximum(a, b) / sc


def get_sd(y, zl, zu, lb_mask, ub_mask, m, nlb, nub, s_max):
    total = (torch.abs(y).sum(-1) + _msum(torch.abs(zl), lb_mask)
             + _msum(torch.abs(zu), ub_mask))
    return torch.clamp_min(total / max(1, m + nlb + nub), s_max) / s_max


def get_sc(zl, zu, lb_mask, ub_mask, nlb, nub, s_max):
    total = _msum(torch.abs(zl), lb_mask) + _msum(torch.abs(zu), ub_mask)
    return torch.clamp_min(total / max(1, nlb + nub), s_max) / s_max


def get_average_complementarity(dl, du, zl, zu, lb_mask, ub_mask, nlb, nub):
    if nlb + nub == 0:
        return _empty_reduce(dl, 0.0)
    return (_msum(dl * zl, lb_mask) + _msum(du * zu, ub_mask)) / (nlb + nub)


def get_min_complementarity(dl, du, zl, zu, lb_mask, ub_mask):
    return torch.minimum(_mmin(dl * zl, lb_mask), _mmin(du * zu, ub_mask))


# -- step sizes --------------------------------------------------------------


def get_alpha_max(x, xl, xu, dx, tau, lb_mask, ub_mask):
    """Fraction-to-the-boundary for the primal step (kernels.jl:356-371)."""
    tau = as_col(tau)
    cand_l = torch.where(lb_mask & (dx < 0), (xl - x) * tau / dx, INF)
    cand_u = torch.where(ub_mask & (dx > 0), (xu - x) * tau / dx, INF)
    if not dx.shape[-1]:
        return _empty_reduce(dx, 1.0)
    return torch.clamp_max(torch.minimum(cand_l.amin(-1), cand_u.amin(-1)), 1.0)


def get_alpha_z(zl, zu, dzl, dzu, tau, lb_mask, ub_mask):
    """Fraction-to-the-boundary for bound duals (kernels.jl:373-388)."""
    tau = as_col(tau)
    cand_l = torch.where(lb_mask & (dzl < 0), -zl * tau / dzl, INF)
    cand_u = torch.where(ub_mask & (dzu < 0), -zu * tau / dzu, INF)
    if not zl.shape[-1]:
        return _empty_reduce(zl, 1.0)
    return torch.clamp_max(torch.minimum(cand_l.amin(-1), cand_u.amin(-1)), 1.0)


def get_rel_search_norm(x, dx):
    return (torch.abs(dx) / (1.0 + torch.abs(x))).amax(-1)


# -- barrier schedule (host floats) -----------------------------------------


def get_mu(mu, mu_min, linear_decrease_factor, superlinear_decrease_power, tol):
    # kernels.jl:697-711 (incl. the issue #242 guard)
    a = min(99.0 * mu_min / tol, 0.01)
    return max(
        max(mu_min, a * tol),
        min(linear_decrease_factor * mu, mu**superlinear_decrease_power),
    )


def get_tau(mu, tau_min):
    return max(tau_min, 1.0 - mu)


# -- filter (host table) ----------------------------------------------------


class Filter(NamedTuple):
    """Fixed-capacity filter, as in the JAX package (the reference keeps an
    unbounded Vector, src/IPM/IPM.jl:99).  When full, the newest entry
    overwrites the last slot.  A batch's filter holds ``(B, K)`` tables and
    a ``(B,)`` count; :func:`filter_lanes` applies the ops below to it."""

    th: np.ndarray    # (K,) float64
    ph: np.ndarray    # (K,) float64
    count: int


def filter_init(capacity: int) -> Filter:
    return Filter(np.full(capacity, INF), np.full(capacity, INF), 0)


def filter_reset(filt: Filter, theta_max) -> Filter:
    """empty! + push!((theta_max, -Inf)) (solver.jl:74)."""
    th = np.full_like(filt.th, INF)
    ph = np.full_like(filt.ph, INF)
    th[0] = theta_max
    ph[0] = -INF
    return Filter(th, ph, 1)


def filter_augment(filt: Filter, theta, varphi, gamma_theta) -> Filter:
    """kernels.jl:755-757."""
    slot = min(filt.count, len(filt.th) - 1)
    th = filt.th.copy()
    ph = filt.ph.copy()
    th[slot] = (1.0 - gamma_theta) * theta
    ph[slot] = varphi - gamma_theta * theta
    return Filter(th, ph, min(filt.count + 1, len(filt.th)))


def filter_lane(filt: Filter, i: int) -> Filter:
    """Lane ``i`` of a batch's filter, as one solve's filter."""
    return Filter(filt.th[i], filt.ph[i], int(filt.count[i]))


def filter_stack(filters) -> Filter:
    """One solve's filters -> a batch's filter, one lane each."""
    return Filter(np.stack([f.th for f in filters]),
                  np.stack([f.ph for f in filters]),
                  np.array([f.count for f in filters], dtype=np.int64))


def filter_lanes(op, filt: Filter, mask, *per_lane) -> Filter:
    """``op(lane_filter, *args)`` on each lane of a batch's filter where the
    numpy ``mask`` holds (the other lanes unchanged); ``per_lane`` are
    ``(B,)`` arrays, lane ``i`` passing their ``i``-th entries."""
    return filter_stack([
        op(filter_lane(filt, i), *(a[i] for a in per_lane)) if on
        else filter_lane(filt, i) for i, on in enumerate(mask)])


def is_filter_acceptable(filt: Filter, theta, varphi) -> bool:
    """kernels.jl:759-769."""
    finite = math.isfinite(theta) and not math.isnan(varphi) and varphi < INF
    c = filt.count
    ok = (theta <= filt.th[:c]) | (varphi <= filt.ph[:c])
    return bool(finite and ok.all())


# -- line-search predicates (host floats) -----------------------------------


def get_alpha_min(
    theta, varphi_d, theta_min, gamma_theta, gamma_phi, alpha_min_frac, delta,
    s_theta, s_phi,
):
    """kernels.jl:715-741."""
    if varphi_d < 0:
        if theta <= theta_min:
            return alpha_min_frac * min(
                gamma_theta,
                min(
                    _div(gamma_phi * theta, -varphi_d),
                    _div(delta * theta**s_theta,
                         max((-varphi_d) ** s_phi, 1e-300)),
                ),
            )
        return alpha_min_frac * min(
            gamma_theta, _div(-gamma_phi * theta, varphi_d))
    return alpha_min_frac * gamma_theta


def is_switching(varphi_d, alpha, s_phi, delta, theta, s_theta) -> bool:
    return (varphi_d < 0) and (
        alpha * (-varphi_d) ** s_phi > delta * theta**s_theta)


def is_armijo(varphi_trial, varphi, eta_phi, alpha, varphi_d) -> bool:
    return varphi_trial <= varphi + eta_phi * alpha * varphi_d


def is_sufficient_progress(
    theta_trial, theta, gamma_theta, varphi_trial, varphi, gamma_phi,
    has_constraints, eps,
) -> bool:
    prog_theta = theta_trial <= (1 - gamma_theta) * theta + 10 * eps * abs(theta)
    prog_phi = varphi_trial <= varphi - gamma_phi * theta + 10 * eps * abs(varphi)
    if has_constraints:
        return prog_theta or prog_phi
    return prog_phi


def is_barr_obj_rapid_increase(varphi, varphi_trial, obj_max_inc) -> bool:
    inc = varphi_trial - varphi
    safe = inc if inc > 0 else 1.0
    return (varphi_trial >= varphi) and (
        _log10(safe) > obj_max_inc + max(1.0, _log10(abs(varphi))))


def _div(a, b):
    """IEEE float division on the host (x/0 = ±inf, 0/0 = nan), as the
    JAX package's device arithmetic gives."""
    return float(np.float64(a) / np.float64(b)) if b == 0 else a / b


def _log10(x):
    if math.isnan(x):
        return x
    if x == INF:
        return INF
    return math.log10(x) if x > 0 else -INF


# ftype codes used in place of the reference's one-char strings
FTYPE_NONE = 0
FTYPE_F = 1       # "f"  Armijo acceptance
FTYPE_H = 2       # "h"  sufficient progress
FTYPE_SOC_F = 3   # "F"  SOC + Armijo
FTYPE_SOC_H = 4   # "H"  SOC + sufficient progress
FTYPE_RESTORE = 5  # "R" soft restoration

FTYPE_CHARS = {0: " ", 1: "f", 2: "h", 3: "F", 4: "H", 5: "R"}


def get_ftype(
    filt, theta, theta_trial, varphi, varphi_trial, switching_condition,
    armijo_condition, theta_min, obj_max_inc, gamma_theta, gamma_phi,
    has_constraints, eps,
) -> int:
    """kernels.jl:803-816 — returns an FTYPE_* code."""
    acceptable = is_filter_acceptable(filt, theta_trial, varphi_trial) and not (
        is_barr_obj_rapid_increase(varphi, varphi_trial, obj_max_inc)
    )
    if not acceptable:
        return FTYPE_NONE
    if (theta <= theta_min) and switching_condition:
        return FTYPE_F if armijo_condition else FTYPE_NONE
    if is_sufficient_progress(theta_trial, theta, gamma_theta, varphi_trial,
                              varphi, gamma_phi, has_constraints, eps):
        return FTYPE_H
    return FTYPE_NONE


# -- variable initialization / maintenance ----------------------------------


def set_initial_bounds(xl, xu, lb_mask, ub_mask, tol):
    """Bound relaxation (kernels.jl:206-218)."""
    if tol <= 0:
        return xl, xu
    xl2 = torch.where(lb_mask, xl - torch.clamp_min(torch.abs(xl), 1.0) * tol, xl)
    xu2 = torch.where(ub_mask, xu + torch.clamp_min(torch.abs(xu), 1.0) * tol, xu)
    return xl2, xu2


def initialize_variables(x, xl, xu, lb_mask, ub_mask, bound_push, bound_fac):
    """Push the initial point into the interior (kernels.jl:638-654)."""
    both = lb_mask & ub_mask
    gap = torch.where(both, xu - xl, 1.0)
    pl = torch.minimum(bound_push * torch.clamp_min(torch.abs(xl), 1.0),
                       bound_fac * gap)
    pu = torch.minimum(bound_push * torch.clamp_min(torch.abs(xu), 1.0),
                       bound_fac * gap)
    x_both = torch.minimum(xu - pu, torch.maximum(xl + pl, x))
    x_lb = torch.maximum(xl + bound_push * torch.clamp_min(torch.abs(xl), 1.0), x)
    x_ub = torch.minimum(xu - bound_push * torch.clamp_min(torch.abs(xu), 1.0), x)
    return torch.where(
        both, x_both,
        torch.where(lb_mask, x_lb, torch.where(ub_mask, x_ub, x)),
    )


def adjust_boundary(x, xl, xu, lb_mask, ub_mask, mu):
    """Relax bounds that the iterate is pressing against (kernels.jl:656-673)."""
    eps = torch.finfo(x.dtype).eps
    c1 = eps * as_col(mu)
    c2 = eps**0.75
    xl2 = torch.where(
        lb_mask & (x - xl < c1), xl - c2 * torch.clamp_min(torch.abs(x), 1.0), xl
    )
    xu2 = torch.where(
        ub_mask & (xu - x < c1), xu + c2 * torch.clamp_min(torch.abs(x), 1.0), xu
    )
    return xl2, xu2


def reset_bound_dual(z, d, mask, mu, kappa_sigma):
    """σ-clipping of bound duals (kernels.jl:775-800); `d` is the slack."""
    mu = as_col(mu)
    d_safe = torch.where(mask, d, 1.0)
    clipped = torch.maximum(
        torch.minimum(z, kappa_sigma * mu / d_safe), mu / (kappa_sigma * d_safe)
    )
    return torch.where(mask, clipped, 0.0)


def dual_inf_perturbation(px, llb_mask, uub_mask, mu, kappa_d):
    """κ_d damping on one-side-bounded variables (kernels.jl:818-823)."""
    mu = as_col(mu)
    return px - torch.where(llb_mask, mu * kappa_d, 0.0) + torch.where(
        uub_mask, mu * kappa_d, 0.0
    )


# -- soft/robust restoration kernels ----------------------------------------


def get_F(c, f, zl, zu, jacl, dl, du, lb_mask, ub_mask, mu):
    """Primal-dual error for soft restoration (kernels.jl:572-610)."""
    mu = as_col(mu)
    F1 = c.abs().sum(-1)
    F2 = (f - zl + zu + jacl).abs().sum(-1)
    okl = (dl >= 0) & (zl >= 0)
    oku = (du >= 0) & (zu >= 0)
    F3 = torch.where(lb_mask, torch.where(okl, (dl * zl - mu).abs(), INF),
                     0.0).sum(-1)
    # N.B. the reference has a typo here ((xu_r - xu_r)*zu_r, kernels.jl:606)
    # making F4's compl term vanish; the JAX package and the port take the
    # intended |du*zu - mu|
    F4 = torch.where(ub_mask, torch.where(oku, (du * zu - mu).abs(), INF),
                     0.0).sum(-1)
    return F1 + F2 + F3 + F4


def get_theta_R(c, p, n):
    return (c - p + n).abs().sum(-1)


def get_inf_pr_R(c, p, n):
    return _amax(c - p + n)


def get_inf_du_R(f_R, y, zl, zu, jacl, zp, zn, rho, sd):
    a = _amax(f_R - zl + zu + jacl)
    if y.shape[-1]:
        a = torch.maximum(a, torch.maximum(_amax(rho - y - zp),
                                           _amax(rho + y - zn)))
    return a / sd


def get_inf_compl_R(dl, du, zl, zu, lb_mask, ub_mask, pp, zp, nn, zn, mu_R, sc):
    mu_R = as_col(mu_R)
    a = _mmax(torch.abs(dl * zl - mu_R), lb_mask)
    b = _mmax(torch.abs(du * zu - mu_R), ub_mask)
    if pp.shape[-1]:
        a = torch.maximum(a, torch.abs(pp * zp - mu_R).amax(-1))
        b = torch.maximum(b, torch.abs(nn * zn - mu_R).amax(-1))
    return torch.maximum(a, b) / sc


def _ratio_min(v, dv, tau):
    """min over dv < 0 of -v·τ/dv (+Inf where none)."""
    return torch.where(dv < 0, -v * tau / dv, INF).amin(-1)


def get_alpha_max_R(x, xl, xu, dx, lb_mask, ub_mask, pp, dpp, nn, dnn, tau_R):
    a = get_alpha_max(x, xl, xu, dx, tau_R, lb_mask, ub_mask)
    if pp.shape[-1]:
        tau = as_col(tau_R)
        a = torch.minimum(a, torch.minimum(_ratio_min(pp, dpp, tau),
                                           _ratio_min(nn, dnn, tau)))
    return a


def get_alpha_z_R(zl, zu, dzl, dzu, lb_mask, ub_mask, zp, dzp, zn, dzn, tau_R):
    a = get_alpha_z(zl, zu, dzl, dzu, tau_R, lb_mask, ub_mask)
    if zp.shape[-1]:
        tau = as_col(tau_R)
        a = torch.minimum(a, torch.minimum(_ratio_min(zp, dzp, tau),
                                           _ratio_min(zn, dzn, tau)))
    return a


def get_varphi_R(obj_val_R, dl, du, lb_mask, ub_mask, pp, nn, mu_R):
    """The restoration problem's barrier function; +Inf outside the
    interior."""
    bad = (lb_mask & (dl < 0)).any(-1) | (ub_mask & (du < 0)).any(-1)
    safe_l = torch.where(lb_mask & (dl > 0), dl, 1.0)
    safe_u = torch.where(ub_mask & (du > 0), du, 1.0)
    val = obj_val_R - mu_R * (torch.log(safe_l).sum(-1)
                              + torch.log(safe_u).sum(-1))
    if pp.shape[-1]:
        bad = bad | (pp < 0).any(-1) | (nn < 0).any(-1)
        val = val - mu_R * (torch.log(torch.where(pp > 0, pp, 1.0)).sum(-1)
                            + torch.log(torch.where(nn > 0, nn, 1.0)).sum(-1))
    return torch.where(bad, INF, val)


def get_varphi_d_R(f_R, dl, du, lb_mask, ub_mask, dx, pp, nn, dpp, dnn, mu_R,
                   rho):
    mu = as_col(mu_R)
    term = (
        f_R
        - torch.where(lb_mask, mu / dl, 0.0)
        + torch.where(ub_mask, mu / du, 0.0)
    )
    out = _dot(term, dx)
    if pp.shape[-1]:
        out = out + _dot(rho - mu / pp, dpp) + _dot(rho - mu / nn, dnn)
    return out


def get_obj_val_R(p, n, D_R, x, x_ref, rho, zeta):
    """ρ Σ(p + n) + ζ/2 ‖D_R (x - x_ref)‖²."""
    val = rho * (p.sum(-1) + n.sum(-1))
    return val + 0.5 * zeta * (D_R**2 * (x - x_ref) ** 2).sum(-1)


def populate_RR_nn(c, mu, rho):
    """Closed-form init of the n-slacks (kernels.jl:825-829)."""
    mu = as_col(mu)
    a = (mu - rho * c) / (2 * rho)
    return a + torch.sqrt(a**2 + mu * c / (2 * rho))
