"""Soft and robust feasibility restoration and the warm start of the port
(``Kernel.restore_step``, ``robust_step``, ``reinitialize`` and the solver's
three-phase loop) against the JAX package, on the CPU.

Held to the JAX package:

* ``suite.infeasible()``, the one-variable infeasible model of
  tests/test_solver.py and ``suite.eigmina()`` on the dense path: status,
  iterations and factorizations exactly; eigmina's objective within 1e-6
  of 1 (tests/test_behavior_suite.py) and within 1e-8 relative of JAX's;
* ``opf.build_sparse(nb=14, seed=0, parametric=True)`` at load scale 2.0,
  banded, float64, whose solve ends INFEASIBLE_PROBLEM_DETECTED after 6
  soft and 26 robust restoration steps, five of which return to the
  regular phase: status, iterations, factorizations and backsolves
  exactly, the phase of every step (from a trace of the hosted loop)
  exactly, ``inf_pr`` at exit within 1e-8 relative; ``solve()``'s
  iteration log row for row (robust rows marked ``r``; the numbers within
  1e-6 relative or 1e-12 absolute);
* one soft and one robust restoration step — the first of each in that
  solve; the robust one sets its restorer up and goes back to the regular
  phase (``back_to_regular``, with least-squares multipliers) — from the
  JAX package's state carried across with ``state_from_arrays``: the
  status, counters and phase exactly, the new iterate within 1e-9
  relative;
* warm starts: hs15 re-solved (status, iterations and factorizations
  exactly), and the nb=14 model re-solved at its own load scale 1.0
  (exactly).  Re-solved at a new scale 1.1, the JAX package keeps the old
  parameters in its state and returns the old optimum (a fault of the
  reference that the port does not copy): the port's warm re-solve
  reaches JAX's cold optimum at 1.1 within 1e-6 relative and carries
  ``theta`` = 1.1.

No load scale of this model at nb = 14 or 30 between 1.0 and 2.0 leaves
restoration and then solves (a scan of the JAX package: each scale solves
without restoration or ends infeasible); the return to the regular phase
is covered by the load-scale-2.0 solve and the robust-step case above.

Each JAX solver is built once and reused across load scales (``state =
None`` before a cold solve), so its steps compile once.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax

import madnlp_tpu as J
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.models.instances import suite as jsuite
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm.state import state_from_arrays
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.models.instances import suite as tsuite
from madnlp_tpu_torch.utils.status import Status as S

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
INF_PR_RTOL = 1e-8
STEP_RTOL = 1e-9
WARM_OBJ_RTOL = 1e-6
ACTIVE = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))
PHASE = {int(S.REGULAR): "g", int(S.RESTORE): "s", int(S.ROBUST): "r"}


def _one_variable_infeasible(pkg):
    """x >= 1 (bound), x <= -1 (constraint) -> infeasible
    (tests/test_solver.py:test_infeasible_detection)."""
    return pkg.create_model(
        obj=lambda x: (x[0] - 2.0) ** 2, n=1, x0=[0.0],
        cons=lambda x: x[0:1], m=1, lvar=[1.0], uvar=[np.inf],
        lcon=[-np.inf], ucon=[-1.0])


DENSE_CASES = {
    "infeasible": (jsuite.infeasible, tsuite.infeasible),
    "one_variable": (lambda: _one_variable_infeasible(J),
                     lambda: _one_variable_infeasible(T)),
    "eigmina": (jsuite.eigmina, tsuite.eigmina),
}


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_path_matches_jax(name):
    jmodel, tmodel = DENSE_CASES[name]
    jstats = J.madnlp(jmodel(), print_level=J.PrintLevel.ERROR)
    tstats = T.madnlp(tmodel(), device="cpu", print_level=T.PrintLevel.ERROR)
    assert tstats.status.name == jstats.status.name
    assert tstats.iter == jstats.iter
    assert (tstats.counters["factorization_cnt"]
            == jstats.counters["factorization_cnt"])
    if name == "eigmina":
        assert tstats.status == T.Status.SOLVE_SUCCEEDED
        assert abs(tstats.objective - 1.0) <= 1e-6
        assert (abs(tstats.objective - jstats.objective)
                <= OBJ_RTOL * abs(jstats.objective))
    else:
        assert tstats.status == T.Status.INFEASIBLE_PROBLEM_DETECTED


# -- the banded path through restoration --------------------------------------


def _opts(pkg, richardson):
    return dict(linear_solver=pkg.LinearSolver.BANDED,
                print_level=pkg.PrintLevel.ERROR,
                richardson=richardson(mu_scaled=True))


def _jax_run(solver, theta, warm=False, keep=()):
    """The JAX package's hosted loop (its ``solve``) with a phase trace;
    ``keep``: step indices whose input state is returned."""
    theta = np.asarray(theta)
    if warm:
        st = jax.jit(solver.kernel.reinitialize)(solver.state, theta)
    else:
        st = solver._init_fn(theta)
    steps = {int(S.REGULAR): solver._regular, int(S.RESTORE): solver._restore,
             int(S.ROBUST): solver._robust}
    phases, kept = [], {}
    while int(st.status) in ACTIVE:
        if len(phases) in keep:
            kept[len(phases)] = st
        phases.append(PHASE[int(st.status)])
        st = steps[int(st.status)](st)
    solver.state = st
    return solver._stats(st, 0.0), "".join(phases), st, kept


def _torch_run(solver, theta, warm=False):
    """The port's hosted loop (its ``solve``) with a phase trace."""
    k = solver.kernel
    theta = solver._params(theta)
    st = k.reinitialize(solver.state, theta) if warm else k.initialize(theta)
    steps = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
             int(S.ROBUST): k.robust_step}
    phases = []
    while st.status in ACTIVE:
        phases.append(PHASE[st.status])
        st = steps[st.status](st)
    solver.state = st
    return solver._stats(st, 0.0), "".join(phases), st


def _torch_opf14():
    return T.MadNLPSolver(topf.build_sparse(nb=14, seed=0, parametric=True),
                          device="cpu", **_opts(T, T.RichardsonOptions))


@pytest.fixture(scope="module")
def jax_opf14():
    """The JAX package's solver for the parametric nb=14 ACOPF, banded,
    float64 (its three steps compiled once for every test here)."""
    return J.MadNLPSolver(jopf.build_sparse(nb=14, seed=0, parametric=True),
                          **_opts(J, JRichardson))


FIRST_SOFT = 10      # the first soft restoration step at load scale 2.0
FIRST_ROBUST = 11    # the first robust step, which goes back to regular


@pytest.fixture(scope="module")
def jax_resto14(jax_opf14):
    jax_opf14.state = None
    return _jax_run(jax_opf14, 2.0, keep=(FIRST_SOFT, FIRST_ROBUST))


def test_opf_restoration_matches_jax(jax_resto14):
    jstats, jphases, jst, _ = jax_resto14
    tstats, tphases, tst = _torch_run(_torch_opf14(), 2.0)
    assert jstats.status.name == "INFEASIBLE_PROBLEM_DETECTED"
    assert (jphases.count("s"), jphases.count("r")) == (6, 26)
    assert jphases.count("rg") == 5  # robust restoration returns to regular
    assert tstats.status.name == jstats.status.name
    assert tstats.iter == jstats.iter
    for c in ("factorization_cnt", "backsolve_cnt"):
        assert tstats.counters[c] == jstats.counters[c], c
    assert tphases == jphases
    assert abs(tst.inf_pr - float(jst.inf_pr)) <= INF_PR_RTOL * float(jst.inf_pr)


def _log_lines(text):
    """The log without the lines that carry wall-clock times."""
    return [ln for ln in text.splitlines()
            if ln and not re.search(r"seconds|secs|[Tt]ime", ln)]


# a log row's numbers: within LOG_RTOL relative, or LOG_ATOL absolute
# (residuals at the rounding level, such as the robust restorer's
# |c - p + n| right after its set-up and the last steps' 1e-11 residuals,
# where only the magnitude carries meaning; the tolerance is 1e-8)
LOG_RTOL = 1e-6
LOG_ATOL = 1e-12


def _same_row(a, b):
    """Two log lines equal token for token (iteration and restoration
    marker, refinement and line-search counts, step type), their decimal
    numbers within LOG_RTOL or LOG_ATOL."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        try:
            fx, fy = float(x), float(y)
        except ValueError:
            return False
        if "." not in x or abs(fx - fy) > max(
                LOG_ATOL, LOG_RTOL * max(abs(fx), abs(fy))):
            return False
    return True


def test_restoration_log_matches_jax(jax_opf14, capsys):
    """``solve()`` through restoration prints the JAX package's log line
    for line (numbers at the rounding level aside): robust restoration
    rows carry the ``r`` marker."""
    opts = jax_opf14.opts
    jax_opf14.state = None
    jax_opf14.opts = dataclasses.replace(opts, print_level=J.PrintLevel.INFO)
    try:
        capsys.readouterr()
        jax_opf14.solve(params=np.asarray(2.0))
        jlog = capsys.readouterr().out
    finally:
        jax_opf14.opts = opts
    solver = T.MadNLPSolver(topf.build_sparse(nb=14, seed=0, parametric=True),
                            device="cpu", linear_solver=T.LinearSolver.BANDED,
                            richardson=T.RichardsonOptions(mu_scaled=True),
                            print_level=T.PrintLevel.INFO)
    solver.solve(params=2.0)
    tlog = capsys.readouterr().out
    assert "EXIT: Converged to a point of local infeasibility" in tlog
    assert sum(ln[4:5] == "r" for ln in tlog.splitlines()) == 26
    tlines, jlines = _log_lines(tlog), _log_lines(jlog)
    assert len(tlines) == len(jlines)
    bad = [(t, j) for t, j in zip(tlines, jlines) if not _same_row(t, j)]
    assert not bad, bad[:3]


def _jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads, the restoration state's included."""
    out = {}

    def put(prefix, v):
        for name, a in zip(v._fields, v):
            if hasattr(a, "_fields"):
                put(f"{prefix}{name}.", a)
            else:
                out[f"{prefix}{name}"] = np.asarray(a)

    for name, v in zip(st._fields, st):
        if name in ("d", "p", "filter", "scal", "RR"):
            put(f"{name}.", v)
        elif isinstance(v, (jax.Array, np.ndarray)):
            out[name] = np.asarray(v)
    return out


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == ref, 0.0, np.abs(a - ref))
    scale = np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0)
    return np.max(diff, initial=0.0) / max(scale, 1e-300)


@pytest.mark.parametrize("index,phase,after", [
    (FIRST_SOFT, "restore", S.ROBUST),
    (FIRST_ROBUST, "robust", S.REGULAR),
])
def test_restoration_step_from_a_jax_state(index, phase, after, jax_opf14,
                                           jax_resto14):
    st = jax_resto14[3][index]
    tst = state_from_arrays(_jax_state_arrays(st), "cpu")
    tst.theta = torch.tensor(2.0, dtype=torch.float64)
    jstep = jax_opf14._restore if phase == "restore" else jax_opf14._robust
    tstep = getattr(_torch_opf14().kernel, f"{phase}_step")
    st = jstep(st)
    tst = tstep(tst)
    assert tst.status == int(st.status) == int(after)
    assert tst.rr_init_needed == bool(st.rr_init_needed)
    for f in ("k", "t_cnt", "factorization_cnt", "backsolve_cnt", "obj_cnt",
              "con_cnt", "grad_cnt", "jac_cnt", "hess_cnt"):
        assert getattr(tst, f) == int(getattr(st, f)), f
    for f in ("x", "y", "zl", "zu", "xl", "xu", "c"):
        assert _rel(getattr(tst, f), getattr(st, f)) < STEP_RTOL, f
    for f in ("alpha", "obj_val"):
        assert _rel(getattr(tst, f), getattr(st, f)) < STEP_RTOL, f
    if phase == "robust":
        for f in ("mu_R", "zeta", "theta_ref"):
            assert _rel(getattr(tst.RR, f), getattr(st.RR, f)) < STEP_RTOL, f
        for f in ("pp", "nn", "zp", "zn"):
            assert _rel(getattr(tst.RR, f), getattr(st.RR, f)) < STEP_RTOL, f


# -- warm start ----------------------------------------------------------------


def test_warm_start_hs15_matches_jax():
    """tests/test_api.py:test_warm_start_resolve, in both packages."""
    js = J.MadNLPSolver(jhs15.build(x0=(1.0, 1.0)),
                        print_level=J.PrintLevel.ERROR)
    ts = T.MadNLPSolver(ths15.build(x0=(1.0, 1.0)), device="cpu",
                        print_level=T.PrintLevel.ERROR)
    for _ in range(2):
        jstats, tstats = js.solve(), ts.solve()
        assert tstats.status == T.Status.SOLVE_SUCCEEDED
        assert tstats.status.name == jstats.status.name
        assert tstats.iter == jstats.iter
        assert (tstats.counters["factorization_cnt"]
                == jstats.counters["factorization_cnt"])
        np.testing.assert_allclose(tstats.solution, jstats.solution,
                                   rtol=1e-7, atol=1e-9)


def test_warm_start_opf_at_new_parameters(jax_opf14):
    """Re-solves of the nb=14 model: at its own load scale the JAX
    package's warm start is the contract (exact); at a new scale it keeps
    the old parameters and returns the old optimum — the port holds the
    new ones and reaches the cold optimum at the new scale."""
    jax_opf14.state = None
    j1, _, _, _ = _jax_run(jax_opf14, 1.0)
    jw, jphases, jst, _ = _jax_run(jax_opf14, 1.0, warm=True)
    ts = _torch_opf14()
    t1, _, _ = _torch_run(ts, 1.0)
    tw, tphases, _ = _torch_run(ts, 1.0, warm=True)
    assert tw.status.name == jw.status.name == "SOLVE_SUCCEEDED"
    assert tw.iter == jw.iter and tphases == jphases
    assert (tw.counters["factorization_cnt"]
            == jw.counters["factorization_cnt"])
    assert abs(tw.objective - jw.objective) <= OBJ_RTOL * abs(jw.objective)

    jold, _, jst, _ = _jax_run(jax_opf14, 1.1, warm=True)
    jax_opf14.state = None
    jcold, _, _, _ = _jax_run(jax_opf14, 1.1)
    # the reference fault: the warm state keeps theta = 1.0
    assert float(jst.theta) == 1.0
    assert abs(jold.objective - j1.objective) <= OBJ_RTOL * j1.objective
    assert abs(jcold.objective - 34.143657380) <= 1e-8 * 34.143657380
    tnew, _, tst = _torch_run(ts, 1.1, warm=True)
    assert float(tst.theta) == 1.1
    assert tnew.status == T.Status.SOLVE_SUCCEEDED
    assert abs(tnew.objective - jcold.objective) <= WARM_OBJ_RTOL * jcold.objective
    assert abs(tnew.objective - jold.objective) > 0.1 * jold.objective


def test_solve_warm_starts_a_solved_solver(capsys):
    """A second ``solve`` re-solves from the last state, as the hosted
    loop's warm start does, and prints the init banner only on the cold
    start."""
    ts = T.MadNLPSolver(topf.build_sparse(nb=14, seed=0, parametric=True),
                        device="cpu", **{**_opts(T, T.RichardsonOptions),
                                         "print_level": T.PrintLevel.INFO})
    capsys.readouterr()
    ts.solve(params=1.0)
    cold = capsys.readouterr().out
    stats = ts.solve(params=1.1)
    warm = capsys.readouterr().out
    assert "Total number of variables" in cold
    assert "Total number of variables" not in warm and "EXIT" in warm
    ref = _torch_opf14()
    _torch_run(ref, 1.0)
    rstats, _, _ = _torch_run(ref, 1.1, warm=True)
    assert stats.iter == rstats.iter and stats.counters == rstats.counters
    assert np.array_equal(stats.solution, rstats.solution)


def test_solve_batch_still_raises_in_restoration():
    solver = _torch_opf14()
    with pytest.raises(NotImplementedError,
                       match="restoration inside solve_batch"):
        solver.solve_batch([1.0, 2.0])
