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

* restoration inside ``solve_batch``: the batch (1.0, 2.0) of the nb=14
  model, driven step by step through ``BatchKernel.step``.  The 2.0 lane
  is the JAX package's single solve at 2.0 (status, iterations,
  factorizations, backsolves and every step's phase exactly); the 1.0 lane
  is the port's single solve (counters exact, objective within 1e-8
  relative, x within 1e-7) and stays bit for bit as it finished while the
  other lane restores.  A chunked and probed batch equals the bulk run.
  One batched restore and one batched robust step from the JAX states
  above, on lane 0 of a batch whose lane 1 is finished: the JAX step on
  lane 0 (the tolerances above), lane 1 untouched.  Marked ``slow``: the
  batch step by step against the JAX package's batched loop, which never
  returns on this batch (ROADMAP §C, R2) and is held up to its last
  step.

No load scale of this model at nb = 14 or 30 between 1.0 and 2.0 leaves
restoration and then solves (a scan of the JAX package: each scale solves
without restoration or ends infeasible); the return to the regular phase
is covered by the load-scale-2.0 solve and the robust-step case above.

Each JAX solver is built once and reused across load scales (``state =
None`` before a cold solve), so its steps compile once.
"""

import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madnlp_tpu as J
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.models.instances import suite as jsuite
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm.state import (BatchState, RRState,
                                        batch_state_from_arrays,
                                        state_from_arrays)
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.models.instances import suite as tsuite
from madnlp_tpu_torch.utils.status import Status as S

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
INF_PR_RTOL = 1e-8
STEP_RTOL = 1e-9
X_TOL = 1e-7
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


def _jax_run(solver, theta, warm=False):
    """The JAX package's hosted loop (its ``solve``) with a phase trace."""
    theta = np.asarray(theta)
    if warm:
        st = jax.jit(solver.kernel.reinitialize)(solver.state, theta)
    else:
        st = solver._init_fn(theta)
    steps = {int(S.REGULAR): solver._regular, int(S.RESTORE): solver._restore,
             int(S.ROBUST): solver._robust}
    phases = []
    while int(st.status) in ACTIVE:
        phases.append(PHASE[int(st.status)])
        st = steps[int(st.status)](st)
    solver.state = st
    return solver._stats(st, 0.0), "".join(phases), st


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


def _traced_solve(solver, steps, keep=()):
    """``solver.solve(params=2.0)`` (either package) with its iteration log
    printed and captured, the phase of every step traced through the step
    functions ``steps`` (attribute names on ``steps[0]``, REGULAR, RESTORE,
    ROBUST in that order) and the input states of the steps in ``keep``.
    Returns (stats, phases, final state, kept states, log)."""
    owner, names = steps
    inner = {n: getattr(owner, n) for n in names}
    phases, kept = [], {}

    def traced(name, mark):
        def step(st):
            if len(phases) in keep:
                kept[len(phases)] = st
            phases.append(mark)
            return inner[name](st)
        return step

    for name, mark in zip(names, "gsr"):
        setattr(owner, name, traced(name, mark))
    opts = solver.opts
    solver.opts = dataclasses.replace(opts, print_level=type(
        opts.print_level).INFO)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            stats = solver.solve(params=np.asarray(2.0))
    finally:
        solver.opts = opts
        for name in names:
            setattr(owner, name, inner[name])
    return stats, "".join(phases), solver.state, kept, out.getvalue()


@pytest.fixture(scope="module")
def jax_resto14(jax_opf14):
    """The JAX package's solve at load scale 2.0, once for every test here:
    (stats, phases, final state, the input states of the first soft and
    the first robust step, log)."""
    jax_opf14.state = None
    return _traced_solve(jax_opf14, (jax_opf14, ("_regular", "_restore",
                                                 "_robust")),
                         keep=(FIRST_SOFT, FIRST_ROBUST))


@pytest.fixture(scope="module")
def torch_resto14():
    """The port's solve at load scale 2.0, the same way."""
    solver = _torch_opf14()
    return _traced_solve(solver, (solver.kernel, ("regular_step",
                                                  "restore_step",
                                                  "robust_step")))


def test_opf_restoration_matches_jax(jax_resto14, torch_resto14):
    jstats, jphases, jst = jax_resto14[:3]
    tstats, tphases, tst = torch_resto14[:3]
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


def test_restoration_log_matches_jax(jax_resto14, torch_resto14):
    """``solve()`` through restoration prints the JAX package's log line
    for line (numbers at the rounding level aside): robust restoration
    rows carry the ``r`` marker."""
    jlog, tlog = jax_resto14[4], torch_resto14[4]
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
    j1, _, _ = _jax_run(jax_opf14, 1.0)
    jw, jphases, jst = _jax_run(jax_opf14, 1.0, warm=True)
    ts = _torch_opf14()
    t1, _, _ = _torch_run(ts, 1.0)
    tw, tphases, _ = _torch_run(ts, 1.0, warm=True)
    assert tw.status.name == jw.status.name == "SOLVE_SUCCEEDED"
    assert tw.iter == jw.iter and tphases == jphases
    assert (tw.counters["factorization_cnt"]
            == jw.counters["factorization_cnt"])
    assert abs(tw.objective - jw.objective) <= OBJ_RTOL * abs(jw.objective)

    jold, _, jst = _jax_run(jax_opf14, 1.1, warm=True)
    jax_opf14.state = None
    jcold, _, _ = _jax_run(jax_opf14, 1.1)
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


# -- restoration inside solve_batch --------------------------------------------


def _assert_same(a, b, where=""):
    """Two lanes' states (or parts of them) equal bit for bit."""
    if isinstance(a, (BatchState, RRState)):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, tuple):
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{where}[{i}]")
    elif torch.is_tensor(a):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=where)
    else:
        np.testing.assert_array_equal(a, b, err_msg=where)


def _torch_batch_run(solver, scales):
    """``solve_batch``'s bulk run driven step by step through
    ``BatchKernel.step``, with each lane's phase trace and a copy of each
    lane taken at the step where it finished."""
    bk = solver.batch_kernel
    st = bk.initialize(torch.tensor(scales, dtype=torch.float64))
    phases, finished = [""] * len(scales), {}
    while np.isin(st.status, ACTIVE).any():
        for i, code in enumerate(st.status):
            if int(code) in PHASE:
                phases[i] += PHASE[int(code)]
            elif i not in finished:
                finished[i] = st.take([i])
        st = bk.step(st)
    return st, phases, finished


@pytest.fixture(scope="module")
def torch_batch14():
    solver = _torch_opf14()
    return (solver,) + _torch_batch_run(solver, [1.0, 2.0])


def test_solve_batch_with_a_restoration_lane(jax_resto14, torch_batch14):
    """The 2.0 lane restores inside the batch and is the JAX package's
    single solve; the 1.0 lane is the port's single solve and stays as it
    finished while the other lane restores."""
    jstats, jphases, jst = jax_resto14[:3]
    solver, st, phases, finished = torch_batch14
    summ = T.batch_summary(solver.prob, st)
    c = summ["counters"]
    assert T.Status(int(summ["status"][1])).name == jstats.status.name
    assert summ["iter"][1] == jstats.iter
    for name in ("factorization_cnt", "backsolve_cnt"):
        assert c[name][1] == jstats.counters[name], name
    assert phases[1] == jphases
    assert (abs(summ["inf_pr"][1] - float(jst.inf_pr))
            <= INF_PR_RTOL * float(jst.inf_pr))

    ref, ref_phases, _ = _torch_run(_torch_opf14(), 1.0)
    assert ref.status == T.Status.SOLVE_SUCCEEDED
    assert T.Status(int(summ["status"][0])) == ref.status
    assert summ["iter"][0] == ref.iter and phases[0] == ref_phases
    for name in ("factorization_cnt", "backsolve_cnt", "obj_cnt", "con_cnt",
                 "grad_cnt", "jac_cnt", "hess_cnt"):
        assert c[name][0] == ref.counters[name], name
    assert abs(summ["objective"][0] - ref.objective) \
        <= OBJ_RTOL * abs(ref.objective)
    np.testing.assert_allclose(summ["x"][0], ref.solution, rtol=0,
                               atol=X_TOL)
    # the 1.0 lane finished first and was not touched again
    assert list(finished) == [0] and len(phases[0]) < len(phases[1])
    _assert_same(st.take([0]), finished[0])
    # solve_batch runs the same steps
    _assert_same(solver.solve_batch([1.0, 2.0]), st)


def test_chunked_batch_with_restoration_lanes_matches_bulk():
    """Probe, sort, chunks and the inverse permutation carry the
    restoration state: the chunked run is the bulk run, lane for lane."""
    scales = [2.0, 1.0, 1.05, 2.0]      # the probe sorts the 2.0 lanes last
    solver = _torch_opf14()
    bulk = solver.solve_batch(scales)
    chunked = solver.solve_batch(scales, chunk_size=2, probe_iters=3)
    assert [T.Status(int(v)).name for v in bulk.status] == [
        "INFEASIBLE_PROBLEM_DETECTED", "SOLVE_SUCCEEDED", "SOLVE_SUCCEEDED",
        "INFEASIBLE_PROBLEM_DETECTED"]
    _assert_same(chunked, bulk)


@pytest.mark.parametrize("index,phase,after", [
    (FIRST_SOFT, "restore", S.ROBUST),
    (FIRST_ROBUST, "robust", S.REGULAR),
])
def test_batched_restoration_step_from_a_jax_state(index, phase, after,
                                                   jax_opf14, jax_resto14):
    """The JAX state of the first soft and the first robust step, carried
    into lane 0 of a batch whose lane 1 holds the same state marked
    finished: one batched step is the JAX step on lane 0 and leaves lane 1
    as it was."""
    st = jax_resto14[3][index]
    one = _jax_state_arrays(st)
    tst = batch_state_from_arrays({k: np.stack([v, v]) for k, v in one.items()},
                                  "cpu")
    tst.status[1] = int(S.SOLVE_SUCCEEDED)
    lane1 = tst.take([1])
    jstep = jax_opf14._restore if phase == "restore" else jax_opf14._robust
    st = jstep(st)
    tst = _torch_opf14().batch_kernel.step(tst)
    assert tst.status[0] == int(st.status) == int(after)
    assert tst.rr_init_needed[0] == bool(st.rr_init_needed)
    for f in ("k", "t_cnt", "factorization_cnt", "backsolve_cnt", "obj_cnt",
              "con_cnt", "grad_cnt", "jac_cnt", "hess_cnt"):
        assert getattr(tst, f)[0] == int(getattr(st, f)), f
    for f in ("x", "y", "zl", "zu", "xl", "xu", "c", "alpha", "obj_val"):
        assert _rel(getattr(tst, f)[0], getattr(st, f)) < STEP_RTOL, f
    if phase == "robust":
        for f in ("mu_R", "zeta", "theta_ref", "pp", "nn", "zp", "zn"):
            assert _rel(getattr(tst.RR, f)[0], getattr(st.RR, f)) \
                < STEP_RTOL, f
    _assert_same(tst.take([1]), lane1)


def _jax_batched_step(solver):
    """One step of the JAX package's ``solve_batch`` loop
    (``madnlp_tpu/ipm/solver.py``, ``batched_step``), built the same way
    from the solver's kernel: ``vmap`` of the three-phase switch while a
    lane is in restoration, active lanes keeping the result."""
    kern = solver.kernel
    cond, body, _ = J.MadNLPSolver._make_loop(kern)

    def step(st):
        special = jnp.any((st.status == int(S.RESTORE))
                          | (st.status == int(S.ROBUST)))
        new = jax.lax.cond(special, jax.vmap(body),
                           jax.vmap(kern.regular_step), st)
        active = jax.vmap(cond)(st)
        return jax.tree_util.tree_map(
            lambda a, b: jnp.where(
                active.reshape((-1,) + (1,) * (a.ndim - 1)), a, b), new, st)

    return jax.jit(step), jax.jit(jax.vmap(kern.initialize))


@pytest.mark.slow
def test_solve_batch_matches_the_jax_batch(jax_opf14):
    """The JAX package's batched loop on the same batch (1.0, 2.0), one
    step at a time beside the port's ``BatchKernel.step``: every lane's
    status and iteration count after every step equal, up to the 2.0
    lane's last step.  That step is not taken in JAX: the JAX package's
    ``solve_batch`` never returns on this batch (ROADMAP §C, R2), since
    under ``vmap`` the robust step runs its continuation beside its
    verdict, and one of its loops does not end from the verdict's state.
    The port's last step is held to the JAX single solve by
    ``test_solve_batch_with_a_restoration_lane``."""
    scales = [1.0, 2.0]
    jstep, jinit = _jax_batched_step(jax_opf14)
    jst = jinit(jnp.asarray(scales))
    bk = _torch_opf14().batch_kernel
    tst = bk.initialize(torch.tensor(scales, dtype=torch.float64))
    trace = []
    while np.isin(tst.status, ACTIVE).any():
        tst = bk.step(tst)
        trace.append((tst.status.copy(), tst.k.copy()))
    assert len(trace) == 66
    for status, k in trace[:-1]:
        jst = jstep(jst)
        np.testing.assert_array_equal(np.asarray(jst.status), status)
        np.testing.assert_array_equal(np.asarray(jst.k), k)
    assert np.asarray(jst.status).tolist() == [int(S.SOLVE_SUCCEEDED),
                                               int(S.ROBUST)]
