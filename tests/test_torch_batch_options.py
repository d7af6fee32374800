"""The step options inside ``solve_batch`` against the JAX package, on the
CPU: the adaptive barriers here, the inertia strategies in
``tests/test_torch_batch_options_inertia.py``, compact L-BFGS, the K2.5
scaling and GMRES in ``tests/test_torch_batch_options_lbfgs.py`` (both
import the helpers below), the port-only checks (chunked runs, the
lane-axis updates) in ``tests/test_torch_batch_options_lanes.py``.

The batch is the parametric ``opf.build_sparse(nb=14, seed=0,
parametric=True)`` at load scales (0.95, 1.0, 1.05), banded, μ-scaled
Richardson (the inertia strategies: the default Richardson, as their
single-solve tests take it), under each option.  Every lane is held to the JAX package's single solve of its
scale under the same option and to the port's own single solve: status,
iterations and ``factorization_cnt`` exactly, the objective within 1e-8
relative, x within 1e-7; ``backsolve_cnt`` within one Richardson sweep
in float64 (the refinement's ratio sits on its tolerance at the last
factorizations of these solves, as for the default options: the JAX
package takes 12 sweeps at scale 1.0 where the port takes 11, ROADMAP C1)
and within 6% in float32 (the ROADMAP rule).  GMRES counts ``max_iter``
backsolves per solve in both packages, so its counts are exact.

One JAX solver per option serves the three scales (``state = None``
before each, so every solve is cold), and the same solver's jitted steps
(``_init_fn``, ``_regular``) give the states for the step tests: one
compile per option (``kkt_system="scaled_sparse"`` shares the K2.5
run's: the JAX package resolves it to ``kkt_scaling="k25"``).  Each file whose tests run JAX solves holds at most
six tests (tests/test_torch_step_options.py says why).

Here also: the batch (1.0, 2.0) under the quality function, whose 2.0
lane restores inside the batch and is the JAX single solve at 2.0 step
for step (status, counters and every step's phase), while the 1.0 lane
is the port's single solve; and one batched step under the quality
function from the JAX package's initial states of the three scales,
carried across with ``batch_state_from_arrays``, against the JAX step of
each lane.  Marked ``slow``: the JAX package's own ``solve_batch`` under
each option (whose compile takes minutes on this CPU).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madnlp_tpu as J
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm.state import batch_state_from_arrays
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.utils.status import Status as S

from test_torch_step_options import options

torch.set_num_threads(1)

SCALES = (0.95, 1.0, 1.05)
OBJ_RTOL = 1e-8
X_TOL = 1e-7
BACKSOLVE_RTOL = 0.06
STEP_RTOL = 1e-9
ACTIVE = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))
PHASE = {int(S.REGULAR): "g", int(S.RESTORE): "s", int(S.ROBUST): "r"}

OPTIONS = {
    "quality_function": {"barrier": "BarrierUpdate.QUALITY_FUNCTION"},
    "loqo": {"barrier": "BarrierUpdate.LOQO"},
    "inertia_free": {"inertia_correction_method": "InertiaCorrection.FREE"},
    "inertia_ignore": {
        "inertia_correction_method": "InertiaCorrection.IGNORE"},
    "compact_lbfgs": {
        "hessian_approximation": "HessianApproximation.COMPACT_LBFGS"},
    "k25_float32": {"kkt_scaling": "k25", "dtype": "float32"},
    "scaled_sparse": {"kkt_system": "scaled_sparse", "dtype": "float32"},
    "gmres": {"iterator": "gmres"},
}
# the JAX reference of an option that another option's run also serves
SAME_REFERENCE = {"scaled_sparse": "k25_float32"}
# the options run with the default Richardson (no μ-scaled tolerance)
PLAIN_RICHARDSON = ("inertia_free", "inertia_ignore")


def _base(pkg, richardson, name):
    out = dict(linear_solver=pkg.LinearSolver.BANDED,
               print_level=pkg.PrintLevel.ERROR)
    if name not in PLAIN_RICHARDSON:
        out["richardson"] = richardson(mu_scaled=True)
    return out


def jax_solver(name):
    return J.MadNLPSolver(jopf.build_sparse(nb=14, seed=0, parametric=True),
                          **_base(J, JRichardson, name),
                          **options(J, OPTIONS[name]))


def torch_solver(name):
    return T.MadNLPSolver(topf.build_sparse(nb=14, seed=0, parametric=True),
                          device="cpu", **_base(T, T.RichardsonOptions, name),
                          **options(T, OPTIONS[name]))


_JAX = {}


def jax_reference(name):
    """The JAX package's solver under option ``name`` and its cold single
    solve of each scale (built and solved once per process)."""
    name = SAME_REFERENCE.get(name, name)
    if name not in _JAX:
        solver = jax_solver(name)
        stats = []
        for sc in SCALES:
            solver.state = None
            stats.append(solver.solve(params=jnp.asarray(sc)))
        _JAX[name] = (solver, stats)
    return _JAX[name]


def assert_lanes_match(name):
    """Every lane of the port's batch against the JAX package's single
    solve of its scale and the port's own, as the module docstring says."""
    _, jstats = jax_reference(name)
    solver = torch_solver(name)
    summ = T.batch_summary(solver.prob, solver.solve_batch(SCALES))
    singles = []
    for sc in SCALES:
        solver.state = None
        singles.append(solver.solve(params=sc))
    float32 = OPTIONS[name].get("dtype") == "float32"
    c = summ["counters"]
    for i, (js, ts) in enumerate(zip(jstats, singles)):
        assert (T.Status(int(summ["status"][i])).name == js.status.name
                == ts.status.name == "SOLVE_SUCCEEDED")
        assert summ["iter"][i] == js.iter == ts.iter
        assert (c["factorization_cnt"][i] == js.counters["factorization_cnt"]
                == ts.counters["factorization_cnt"])
        assert c["hess_cnt"][i] == js.counters["hess_cnt"]
        for ref in (js, ts):
            want = ref.counters["backsolve_cnt"]
            got = c["backsolve_cnt"][i]
            if float32:
                assert abs(got - want) <= BACKSOLVE_RTOL * want
            else:
                assert abs(got - want) <= 1
            assert (abs(summ["objective"][i] - ref.objective)
                    <= OBJ_RTOL * abs(ref.objective))
        np.testing.assert_allclose(summ["x"][i], np.asarray(js.solution),
                                   rtol=0, atol=X_TOL)
    return summ


@pytest.mark.parametrize("name", ["quality_function", "loqo"])
def test_batch_lanes_match_jax(name):
    summ = assert_lanes_match(name)
    assert (summ["counters"]["hess_cnt"] > 0).all()


# -- restoration under the quality function -------------------------------


def _jax_run(solver, theta):
    """The JAX package's hosted loop (its ``solve``) with a phase trace and
    the input state of each step that enters robust restoration from soft
    restoration."""
    st = solver._init_fn(jnp.asarray(theta))
    steps = {int(S.REGULAR): solver._regular, int(S.RESTORE): solver._restore,
             int(S.ROBUST): solver._robust}
    phases, entries = [], []
    while int(st.status) in ACTIVE:
        if phases and phases[-1] == "s" and int(st.status) == int(S.ROBUST):
            entries.append(st)
        phases.append(PHASE[int(st.status)])
        st = steps[int(st.status)](st)
    return solver._stats(st, 0.0), "".join(phases), st, entries


def _torch_batch_run(solver, scales):
    """``solve_batch``'s bulk run driven through ``BatchKernel.step``,
    with each lane's phase trace."""
    bk = solver.batch_kernel
    st = bk.initialize(torch.tensor(scales, dtype=torch.float64))
    phases = [""] * len(scales)
    while np.isin(st.status, ACTIVE).any():
        for i, code in enumerate(st.status):
            if int(code) in PHASE:
                phases[i] += PHASE[int(code)]
        st = bk.step(st)
    return st, phases


def _ulp(a, seed):
    """``a`` with every entry moved by at most one float64 ulp (seeded), as
    tools/spread.py moves a start."""
    rng = np.random.default_rng(seed)
    eps = np.finfo(np.float64).eps
    return a * (1.0 + eps * rng.integers(-1, 2, np.shape(a)))


def test_restoration_lane_under_the_quality_function():
    """The 2.0 lane restores inside the batch: status, iterations,
    factorizations, restoration steps and every step's phase are the JAX
    single solve's, the counters the port's single solve's.  Its
    backsolves part from JAX's at the robust steps entered from soft
    restoration: there the first refinement sweep's ratio sits next to
    the tolerance (1.9e-10 against 1e-10 in the port, its mat-vec
    rounding floor near 1e-15), so one sweep or two is rounding of the
    factor.  The JAX package's own one-ulp twins of the first such state
    take one sweep and two, and the lane is held to JAX's count plus at
    most one sweep per such step."""
    jsolver, _ = jax_reference("quality_function")
    jstats, jphases, jst, entries = _jax_run(jsolver, 2.0)
    assert jstats.status.name == "INFEASIBLE_PROBLEM_DETECTED"
    assert len(entries) == jphases.count("sr") > 0
    solver = torch_solver("quality_function")
    st, phases = _torch_batch_run(solver, [1.0, 2.0])
    summ = T.batch_summary(solver.prob, st)
    c = summ["counters"]
    assert T.Status(int(summ["status"][1])).name == jstats.status.name
    assert summ["iter"][1] == jstats.iter
    for name in ("factorization_cnt", "t"):
        assert c[name][1] == jstats.counters[name], name
    assert phases[1] == jphases
    jb = jstats.counters["backsolve_cnt"]
    assert jb <= c["backsolve_cnt"][1] <= jb + len(entries)
    assert (abs(summ["inf_pr"][1] - float(jst.inf_pr))
            <= OBJ_RTOL * float(jst.inf_pr))
    first = entries[0]
    sweeps = {int(jsolver._robust(first._replace(
        x=jnp.asarray(_ulp(np.asarray(first.x), seed)))).backsolve_cnt)
        - int(first.backsolve_cnt) for seed in range(1, 9)}
    assert sweeps == {1, 2}
    for i, sc in enumerate((1.0, 2.0)):
        solver.state = None
        ref = solver.solve(params=sc)
        assert T.Status(int(summ["status"][i])) == ref.status
        assert summ["iter"][i] == ref.iter
        for name in ("factorization_cnt", "backsolve_cnt", "obj_cnt",
                     "con_cnt", "grad_cnt", "jac_cnt", "hess_cnt", "t"):
            assert c[name][i] == ref.counters[name], (i, name)
        assert abs(summ["objective"][i] - ref.objective) \
            <= OBJ_RTOL * abs(ref.objective)


# -- one batched step from the JAX package's states -----------------------


def jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads (nested tuples by dotted keys; the
    persisted context left out)."""
    out = {}

    def put(prefix, v):
        for name, a in zip(v._fields, v):
            if hasattr(a, "_fields"):
                put(f"{prefix}{name}.", a)
            else:
                out[f"{prefix}{name}"] = np.asarray(a)

    for name, v in zip(st._fields, st):
        if name == "ctx":
            continue
        if hasattr(v, "_fields"):
            put(f"{name}.", v)
        else:
            out[name] = np.asarray(v)
    return out


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == ref, 0.0, np.abs(a - ref))
    scale = np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0)
    return np.max(diff, initial=0.0) / max(scale, 1e-300)


def batched_step_from_jax(name, steps):
    """The JAX states of the three scales after ``steps`` regular steps,
    stacked and carried across; one batched step of the port from them
    beside the JAX step of each lane.  Under an adaptive barrier the
    port's batch takes its own least-squares factorization as the probing
    solves' context (``steps`` = 0).  Returns (port state, JAX states)."""
    jsolver, _ = jax_reference(name)
    jst = [jsolver._init_fn(jnp.asarray(sc)) for sc in SCALES]
    for _ in range(steps):
        jst = [jsolver._regular(s) for s in jst]
    lanes = [jax_state_arrays(s) for s in jst]
    tst = batch_state_from_arrays(
        {k: np.stack([a[k] for a in lanes]) for k in lanes[0]}, "cpu")
    bk = torch_solver(name).batch_kernel
    if bk.single._persist_ctx:
        assert steps == 0
        tst.ctx = bk.initialize(tst.theta).ctx
    return bk.step(tst), [jsolver._regular(s) for s in jst]


def assert_step_matches(tst, jnext, fields):
    for i, js in enumerate(jnext):
        assert tst.status[i] == int(js.status) == int(S.REGULAR)
        for f in ("k", "factorization_cnt", "backsolve_cnt", "obj_cnt",
                  "con_cnt", "grad_cnt", "jac_cnt", "hess_cnt"):
            assert getattr(tst, f)[i] == int(getattr(js, f)), (i, f)
        for f in fields:
            assert _rel(getattr(tst, f)[i], getattr(js, f)) < STEP_RTOL, \
                (i, f)


def test_batched_quality_function_step_from_jax_states():
    tst, jnext = batched_step_from_jax("quality_function", 0)
    assert_step_matches(tst, jnext, ("x", "y", "zl", "zu", "mu", "tau",
                                     "alpha", "obj_val"))
    np.testing.assert_array_equal(
        tst.barrier_free_mode, [bool(s.barrier_free_mode) for s in jnext])


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_jax_solve_batch_under_the_option(name):
    """The JAX package's own ``solve_batch`` of the same batch returns and
    equals the port's lanes in status, iterations and factorizations."""
    jsolver = jax_solver(name)
    jst = jsolver.solve_batch(jnp.asarray(SCALES))
    solver = torch_solver(name)
    summ = T.batch_summary(solver.prob, solver.solve_batch(SCALES))
    np.testing.assert_array_equal(np.asarray(jst.status), summ["status"])
    np.testing.assert_array_equal(np.asarray(jst.k), summ["iter"])
    np.testing.assert_array_equal(np.asarray(jst.factorization_cnt),
                                  summ["counters"]["factorization_cnt"])
