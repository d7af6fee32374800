"""Fault C1 (ROADMAP §C): the flagship's float64 backsolve count, settled
as rounding.

The port's float64 solve of ``opf.build_sparse(nb=600, seed=0)`` (banded
KKT, μ-scaled Richardson) takes 25 iterations, 25 factorizations and 28
backsolves; the JAX package takes 29.  The counts part at iteration 24
(μ = 2.5e-9, Richardson tolerance 1e-10), where the port refines twice and
the JAX package three times.  There the refinement operator's band carries
Σ = z/(x − l) up to 2.3e13 on its diagonal, and its mat-vec's rounding
alone, eps·max_i Σ_j |K_ij||x_j|, is 4.9e-9 of the ratio's denominator:
49 times the tolerance.  Whether the second sweep's computed residual
falls below the tolerance is decided by the mat-vec's summation order
(XLA's against torch's), not by the algorithm.

``test_iteration_24_is_below_rounding`` captures the KKT inputs and
right-hand side of the port's refinement at iteration 24 on the CPU,
shows that rounding floor, and refines the same inputs, and their one-ulp
perturbations, with the JAX package's KKT system: 2 or 3 sweeps.
``test_whole_solve_spread`` (slow) solves both packages from the initial
point perturbed by one float64 ulp: both keep 25 iterations and 25
factorizations and take 27-29 backsolves (the port's 28 and the JAX
package's 29 among them), the spread that ``chip_smoke.py`` holds the card
to (``FLAGSHIP_FLOAT64_BACKSOLVES``).

``test_step_option_sweeps_part_below_rounding`` (slow) does the same for
the step options whose float64 flagship backsolves part from the JAX
package's (the quality-function and LOQO barriers, the inertia-free
correction): it replays every refinement of the port's solve on the same
inputs in the JAX package's KKT system and finds the calls whose sweep
counts differ, each at the last factorizations with its rounding floor
above its tolerance.

Run the whole study (a few minutes on the CPU), or one step option's
replay (about a minute):

    PYTHONPATH=. python tests/test_torch_refine_f64.py
    PYTHONPATH=. python tests/test_torch_refine_f64.py quality_function
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madnlp_tpu as J
from madnlp_tpu.kkt.vec import KKTVec as JVec
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.kkt.vec import KKTVec as TVec
from madnlp_tpu_torch.kkt.vec import norm_inf
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.ops.banded import banded_symv

torch.set_num_threads(1)

ITERATION = 24          # the iteration whose refinement the counts part at
TOL = 1e-10             # its Richardson tolerance: max(tol, min(cap, 0.1·μ))
SEEDS = range(1, 7)     # one-ulp perturbations
SPREAD = (27, 29)       # whole-solve float64 backsolves over one-ulp starts
EPS = np.finfo(np.float64).eps


def _port_solver(model=None, **opts):
    return T.MadNLPSolver(
        topf.build_sparse(nb=600, seed=0) if model is None else model,
        device="cpu", linear_solver=T.LinearSolver.BANDED, dtype="float64",
        richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR, **opts)


def _jax_options(**opts):
    return dict(linear_solver=J.LinearSolver.BANDED, dtype="float64",
                richardson=JRichardson(mu_scaled=True),
                print_level=J.PrintLevel.ERROR, **opts)


def _ulp(a, seed):
    """``a`` with every entry moved by at most one ulp (seeded)."""
    rng = np.random.default_rng(seed)
    return a * (1.0 + EPS * rng.integers(-1, 2, np.shape(a)))


def capture(**opts):
    """The port's float64 flagship solve on the CPU (under the step
    options ``opts``), with the KKT inputs, right-hand side, μ and sweep
    count of every refinement of an IPM iteration (the least-squares dual
    initialization's is left out)."""
    solver = _port_solver(**opts)
    kkt = solver.kernel.kkt
    build, refine = kkt.build_and_factorize, kkt.solve_refine
    last, calls = {}, []

    def building(*args, **kwargs):
        last["args"] = [a.clone().numpy() for a in args]
        last["factorization"] = last.get("factorization", 0) + 1
        return build(*args, **kwargs)

    def refining(ctx, b, mu=None, active=None):
        out = refine(ctx, b, mu=mu, active=active)
        if mu is not None:
            calls.append({"args": last["args"], "mu": mu, "sweeps": out[2],
                          "b": [a.clone().numpy() for a in b],
                          "factorization": last["factorization"]})
        return out

    kkt.build_and_factorize, kkt.solve_refine = building, refining
    stats = solver.solve()
    return stats, calls


@pytest.fixture(scope="module")
def captured():
    return capture()


def _jax_sweeps(calls_at, seeds):
    """The JAX package's sweeps when it factors and refines the captured
    inputs (unperturbed, then each seed's one-ulp perturbation)."""
    kkt = J.MadNLPSolver(jopf.build_sparse(nb=600, seed=0),
                         **_jax_options()).kernel.kkt
    run = jax.jit(lambda args, b, mu: kkt.solve_refine(
        kkt.build_and_factorize(*args), b, mu=mu)[2])
    b = JVec(*(jnp.asarray(a) for a in calls_at["b"]))
    mu = jnp.asarray(calls_at["mu"])
    out = []
    for seed in [None, *seeds]:
        args = [jnp.asarray(a if seed is None else _ulp(a, seed))
                for a in calls_at["args"]]
        out.append(int(run(args, b, mu)))
    return out


def rounding_floor(kkt, ctx, b, x):
    """The refinement ratio's rounding floor at ``x``: eps·max_i Σ_j
    |K_ij||x_j| (the terms of the operator's mat-vec before they cancel)
    over the ratio's denominator min(‖x‖, 1e6‖b‖) + ‖b‖."""
    p = kkt.prob
    ax = torch.cat([x.xp, x.y]).abs()
    s = banded_symv(kkt.bstruct, ctx.factor.opband.abs(),
                    ax[kkt._bperm])[kkt._biperm]
    sigma = (torch.where(kkt.lb, ctx.zl / ctx.dl, 0.0)
             + torch.where(kkt.ub, ctx.zu / ctx.du_, 0.0))
    s[:p.nw] += sigma.abs() * x.xp.abs()
    nb, nx = float(norm_inf(b)), float(norm_inf(x))
    return EPS * float(s.max()) / (min(nx, 1e6 * nb) + nb)


def test_iteration_24_is_below_rounding(captured):
    """At iteration 24 the mat-vec's rounding floor lies far above the
    refinement tolerance, so the sweep count there is rounding: the JAX
    package refines the port's own inputs, and their one-ulp
    perturbations, in 2 or 3 sweeps, and the port takes 2."""
    stats, calls = captured
    assert stats.status.name == "SOLVE_SUCCEEDED"
    c = stats.counters
    assert (stats.iter, c["factorization_cnt"]) == (25, 25)
    assert SPREAD[0] <= c["backsolve_cnt"] <= SPREAD[1]
    at = calls[ITERATION - 1]
    assert at["mu"] == pytest.approx(2.506e-9, rel=1e-3)
    assert at["sweeps"] == 2
    kkt = _port_solver().kernel.kkt
    assert max(kkt.opts.richardson_tol,
               min(kkt.opts.richardson.mu_tol_cap,
                   kkt.opts.richardson.mu_tol_factor * at["mu"])) == TOL
    ctx = kkt.build_and_factorize(*(torch.as_tensor(a) for a in at["args"]))
    b = TVec(*(torch.as_tensor(a) for a in at["b"]))
    x, ok, sweeps = kkt.solve_refine(ctx, b, mu=at["mu"])
    assert ok and sweeps == 2
    assert rounding_floor(kkt, ctx, b, x) > 10 * TOL
    assert set(_jax_sweeps(at, SEEDS)) <= {2, 3}
    for seed in SEEDS:
        ctx = kkt.build_and_factorize(
            *(torch.as_tensor(_ulp(a, seed)) for a in at["args"]))
        assert kkt.solve_refine(ctx, b, mu=at["mu"])[2] in (2, 3)


# The step options whose float64 flagship backsolves part from the JAX
# package's (the port's CPU solve against the pins of chip_smoke.py's
# STEP_REFERENCE): iterations and factorizations equal, backsolves
# (port, JAX).
STEP_OPTION_BACKSOLVES = {
    "quality_function": ({"barrier": T.BarrierUpdate.QUALITY_FUNCTION},
                         {"barrier": J.BarrierUpdate.QUALITY_FUNCTION},
                         (35, 39), (41, 43)),
    "loqo": ({"barrier": T.BarrierUpdate.LOQO},
             {"barrier": J.BarrierUpdate.LOQO}, (26, 26), (27, 28)),
    "inertia_free": (
        {"inertia_correction_method": T.InertiaCorrection.FREE},
        {"inertia_correction_method": J.InertiaCorrection.FREE},
        (25, 25), (53, 54)),
}


def _tolerance(kkt, mu):
    r = kkt.opts.richardson
    return max(kkt.opts.richardson_tol, min(r.mu_tol_cap,
                                            r.mu_tol_factor * mu))


def sweep_parting(name):
    """Every refinement of the port's float64 flagship solve under the
    step option ``name`` on the CPU, replayed on the same inputs by the
    JAX package's KKT system (its operator, in XLA's summation order):
    the port's solve, and for each call whose sweep counts differ its
    factorization, μ, both counts, the tolerance and the rounding floor
    of the refinement ratio there (``rounding_floor``)."""
    topts, jopts, _, _ = STEP_OPTION_BACKSOLVES[name]
    stats, calls = capture(**topts)
    jkkt = J.MadNLPSolver(jopf.build_sparse(nb=600, seed=0),
                          **_jax_options(**jopts)).kernel.kkt
    run = jax.jit(lambda args, b, mu: jkkt.solve_refine(
        jkkt.build_and_factorize(*args), b, mu=mu)[2])
    kkt = _port_solver(**topts).kernel.kkt
    parted, jax_total = [], 0
    for at in calls:
        b = JVec(*(jnp.asarray(a) for a in at["b"]))
        sweeps = int(run([jnp.asarray(a) for a in at["args"]], b,
                         jnp.asarray(at["mu"])))
        jax_total += sweeps
        if sweeps == at["sweeps"]:
            continue
        ctx = kkt.build_and_factorize(*(torch.as_tensor(a)
                                        for a in at["args"]))
        tb = TVec(*(torch.as_tensor(a) for a in at["b"]))
        x, _, again = kkt.solve_refine(ctx, tb, mu=at["mu"])
        assert again == at["sweeps"]
        parted.append({"factorization": at["factorization"],
                       "mu": at["mu"], "port": at["sweeps"], "jax": sweeps,
                       "tolerance": _tolerance(kkt, at["mu"]),
                       "floor": rounding_floor(kkt, ctx, tb, x)})
    return stats, calls, parted, jax_total


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(STEP_OPTION_BACKSOLVES))
def test_step_option_sweeps_part_below_rounding(name):
    """Under the quality-function and LOQO barriers and the inertia-free
    correction the port's float64 flagship solve takes the JAX package's
    iterations and factorizations, and one or two backsolves fewer.
    Replayed on the port's own inputs by the JAX package's KKT system,
    the sweep counts differ only at refinements of the last factorizations
    (μ at its floor), whose rounding floor lies above their tolerance (the
    C1 mechanism): the JAX package's operator, summed in XLA's order,
    takes another number of sweeps than the port's on the very same
    inputs (more under the barriers, fewer under the inertia-free
    correction)."""
    _, _, (it, fact), (port_back, _) = STEP_OPTION_BACKSOLVES[name]
    stats, _, parted, _ = sweep_parting(name)
    c = stats.counters
    assert (stats.status.name, stats.iter, c["factorization_cnt"],
            c["backsolve_cnt"]) == ("SOLVE_SUCCEEDED", it, fact, port_back)
    assert parted
    for at in parted:
        assert at["floor"] > at["tolerance"], at
        assert at["factorization"] >= fact - 1, at


def _perturbed_start(model, seed):
    model.x0 = _ulp(model.x0, seed)
    return model


def whole_solve_counts(seeds=SEEDS):
    """(iterations, factorizations, backsolves) of both packages' float64
    flagship solves from the initial point perturbed by one ulp."""
    out = {"port": [], "jax": []}
    for seed in seeds:
        s = _port_solver(_perturbed_start(
            topf.build_sparse(nb=600, seed=0), seed)).solve()
        out["port"].append((s.status.name, s.iter,
                            s.counters["factorization_cnt"],
                            s.counters["backsolve_cnt"]))
        s = J.madnlp(_perturbed_start(jopf.build_sparse(nb=600, seed=0),
                                      seed), **_jax_options())
        out["jax"].append((s.status.name, s.iter,
                           s.counters["factorization_cnt"],
                           s.counters["backsolve_cnt"]))
    return out


@pytest.mark.slow
def test_whole_solve_spread():
    """From one-ulp perturbed starts both packages keep 25 iterations and
    25 factorizations, and their backsolve counts spread over 27-29, which
    holds the port's 28 and the JAX package's 29."""
    out = whole_solve_counts()
    backs = set()
    for runs in out.values():
        for status, it, fact, back in runs:
            assert (status, it, fact) == ("SOLVE_SUCCEEDED", 25, 25)
            backs.add(back)
    assert min(backs) >= SPREAD[0] and max(backs) <= SPREAD[1]
    assert {28, 29} <= backs


if __name__ == "__main__":
    import sys

    if sys.argv[1:]:
        # PYTHONPATH=. python tests/test_torch_refine_f64.py quality_function
        stats, calls, parted, jax_total = sweep_parting(sys.argv[1])
        print("port:", stats.iter, stats.counters["factorization_cnt"],
              stats.counters["backsolve_cnt"], "sweeps",
              sum(at["sweeps"] for at in calls), "JAX's replay", jax_total)
        for at in parted:
            print(at)
        sys.exit()
    stats, calls = capture()
    at = calls[ITERATION - 1]
    print("port:", stats.iter, stats.counters["factorization_cnt"],
          stats.counters["backsolve_cnt"], "sweeps at iteration",
          ITERATION, at["sweeps"], "mu", at["mu"])
    kkt = _port_solver().kernel.kkt
    ctx = kkt.build_and_factorize(*(torch.as_tensor(a) for a in at["args"]))
    b = TVec(*(torch.as_tensor(a) for a in at["b"]))
    x = kkt.solve_refine(ctx, b, mu=at["mu"])[0]
    print("rounding floor of the ratio:", rounding_floor(kkt, ctx, b, x),
          "tolerance", TOL)
    print("JAX on the same inputs, then one-ulp perturbations:",
          _jax_sweeps(at, SEEDS))
    print("whole solves from one-ulp starts:", whole_solve_counts())
