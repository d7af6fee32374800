"""Elementwise parity of the port's IPM reductions (madnlp_tpu_torch/ipm/
kernels.py) with the JAX package's (madnlp_tpu/ipm/kernels.py) on one
numpy-seeded masked state: the same float64 formulas, agreement to 1e-13
relative (summation order differs).  Also ``curvature``
(ipm/quasi_newton.py), the σ-initialization strategies of the
quasi-Newton updates (quasi_newton.jl:48-61), on a seeded secant pair:
within 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madnlp_tpu  # noqa: F401  (float64 in JAX)
from madnlp_tpu.ipm import kernels as JK
from madnlp_tpu.ipm import quasi_newton as jqn
from madnlp_tpu.utils.options import BFGSInitStrategy as JInit
from madnlp_tpu_torch.ipm import kernels as TK
from madnlp_tpu_torch.ipm import quasi_newton as tqn
from madnlp_tpu_torch.utils.options import BFGSInitStrategy as TInit

from test_torch_step_options import close, secant_pairs

torch.set_num_threads(1)

RTOL = 1e-13


def _state(seed=0, n=60, m=25):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    xl = np.where(rng.random(n) < 0.7, x - rng.uniform(0.01, 2.0, n), -np.inf)
    xu = np.where(rng.random(n) < 0.5, x + rng.uniform(0.01, 2.0, n), np.inf)
    lb, ub = np.isfinite(xl), np.isfinite(xu)
    return dict(
        x=x, xl=xl, xu=xu, lb=lb, ub=ub,
        zl=np.where(lb, rng.uniform(0.1, 3.0, n), 0.0),
        zu=np.where(ub, rng.uniform(0.1, 3.0, n), 0.0),
        dx=rng.standard_normal(n), dzl=rng.standard_normal(n),
        dzu=rng.standard_normal(n), f=rng.standard_normal(n),
        jacl=rng.standard_normal(n), y=rng.standard_normal(m),
        c=rng.standard_normal(m), llb=lb & ~ub, uub=ub & ~lb,
    )


S = _state()
NLB, NUB, M = int(S["lb"].sum()), int(S["ub"].sum()), len(S["y"])


def _args(pkg, names):
    """The state's arrays as the package's arrays; scalars pass through."""
    out = []
    for a in names:
        if isinstance(a, str):
            v = S[a]
            out.append(jnp.asarray(v) if pkg is JK else torch.as_tensor(v))
        else:
            out.append(a)
    return out


def _slack_args(pkg, rest):
    dl, du = pkg.slacks(*_args(pkg, ["x", "xl", "xu", "lb", "ub"]))
    return [dl, du] + _args(pkg, rest)


CASES = {
    "slacks": lambda p: p.slacks(*_args(p, ["x", "xl", "xu", "lb", "ub"])),
    "get_varphi": lambda p: p.get_varphi(1.7, *_slack_args(p, ["lb", "ub", 0.1])),
    "get_varphi_d": lambda p: p.get_varphi_d(
        _args(p, ["f"])[0], *_slack_args(p, ["lb", "ub", "dx", 0.1])),
    "get_inf_pr": lambda p: p.get_inf_pr(*_args(p, ["c"])),
    "get_theta": lambda p: p.get_theta(*_args(p, ["c"])),
    "get_inf_du": lambda p: p.get_inf_du(*_args(p, ["f", "zl", "zu", "jacl", 1.3])),
    "get_inf_compl": lambda p: p.get_inf_compl(
        *_slack_args(p, ["zl", "zu", "lb", "ub", 0.1, 1.2])),
    "get_sd": lambda p: p.get_sd(*_args(p, ["y", "zl", "zu", "lb", "ub", M, NLB,
                                             NUB, 100.0])),
    "get_sc": lambda p: p.get_sc(*_args(p, ["zl", "zu", "lb", "ub", NLB, NUB,
                                             100.0])),
    "get_average_complementarity": lambda p: p.get_average_complementarity(
        *_slack_args(p, ["zl", "zu", "lb", "ub", NLB, NUB])),
    "get_min_complementarity": lambda p: p.get_min_complementarity(
        *_slack_args(p, ["zl", "zu", "lb", "ub"])),
    "get_alpha_max": lambda p: p.get_alpha_max(
        *_args(p, ["x", "xl", "xu", "dx", 0.99, "lb", "ub"])),
    "get_alpha_z": lambda p: p.get_alpha_z(
        *_args(p, ["zl", "zu", "dzl", "dzu", 0.99, "lb", "ub"])),
    "get_rel_search_norm": lambda p: p.get_rel_search_norm(*_args(p, ["x", "dx"])),
    "get_mu": lambda p: p.get_mu(0.1, 1e-11, 0.2, 1.5, 1e-8),
    "get_tau": lambda p: p.get_tau(0.1, 0.99),
    "get_alpha_min": lambda p: p.get_alpha_min(0.3, -2.0, 1e-4, 1e-5, 1e-5,
                                               0.05, 1.0, 1.1, 2.3),
    "set_initial_bounds": lambda p: p.set_initial_bounds(
        *_args(p, ["xl", "xu", "lb", "ub", 1e-8])),
    "initialize_variables": lambda p: p.initialize_variables(
        *_args(p, ["x", "xl", "xu", "lb", "ub", 1e-2, 1e-2])),
    "adjust_boundary": lambda p: p.adjust_boundary(
        *_args(p, ["x", "xl", "xu", "lb", "ub", 1e-3])),
    "reset_bound_dual": lambda p: p.reset_bound_dual(
        _args(p, ["zl"])[0], p.slacks(*_args(p, ["x", "xl", "xu", "lb", "ub"]))[0],
        *_args(p, ["lb", 0.1, 1e10])),
    "dual_inf_perturbation": lambda p: p.dual_inf_perturbation(
        *_args(p, ["f", "llb", "uub", 0.1, 1e-5])),
}


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [a for x in v for a in _flat(x)]
    if isinstance(v, torch.Tensor):
        return [v.numpy()]
    return [np.asarray(v)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ipm_kernel_matches_jax(name):
    got, ref = _flat(CASES[name](TK)), _flat(CASES[name](JK))
    assert len(got) == len(ref)
    for a, r in zip(got, ref):
        a, r = np.asarray(a, np.float64), np.asarray(r, np.float64)
        assert a.shape == r.shape
        same = (a == r) | (np.isnan(a) & np.isnan(r))
        with np.errstate(invalid="ignore"):
            diff = np.where(same, 0.0, np.abs(a - r))
        scale = np.max(np.abs(r[np.isfinite(r)]), initial=0.0)
        assert np.max(diff, initial=0.0) <= RTOL * max(scale, 1e-300)


@pytest.mark.parametrize("strategy", [s.name for s in TInit])
def test_curvature_matches_jax(strategy):
    (s, y), = secant_pairs(7, 1, 0)
    close(tqn.curvature(TInit[strategy], torch.tensor(s), torch.tensor(y)),
          jqn.curvature(JInit[strategy], jnp.asarray(s), jnp.asarray(y)))
