"""Checkpoint / resume of the port (``madnlp_tpu_torch.utils.checkpoint``),
on the CPU, without the JAX package.

* A solve of ``opf.build_sparse(nb=14, seed=0, parametric=True)`` at load
  scale 2.0 (banded, float64; it passes through soft and robust
  restoration) driven by hand through the three-phase loop, saved after 4
  steps (regular phase) and after 23 (inside robust restoration), loaded
  into a fresh solver and finished there: status, counters and the
  solution equal to the uninterrupted solve's bit for bit.
* ``solve()`` on a solver whose state came from ``resume`` warm-starts
  (``Kernel.reinitialize``), as the JAX package's does: bit for bit the
  warm re-solve of the solver that saved it.
* ``load_state`` is strict: a missing field, an extra field, an ``x`` of
  another length and an ``x`` of another dtype each raise ``ValueError``
  naming the field.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf
from madnlp_tpu_torch.utils.checkpoint import (load_state, resume, save_state,
                                               state_arrays)
from madnlp_tpu_torch.utils.status import Status as S

torch.set_num_threads(1)

ACTIVE = (int(S.REGULAR), int(S.RESTORE), int(S.ROBUST))


def _solver():
    return T.MadNLPSolver(
        opf.build_sparse(nb=14, seed=0, parametric=True), device="cpu",
        linear_solver=T.LinearSolver.BANDED,
        richardson=T.RichardsonOptions(mu_scaled=True),
        print_level=T.PrintLevel.ERROR)


def _steps(solver, st, n=None):
    """At most ``n`` steps of the three-phase loop (all, for None)."""
    k = solver.kernel
    step = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
            int(S.ROBUST): k.robust_step}
    done = 0
    while st.status in ACTIVE and (n is None or done < n):
        st = step[st.status](st)
        done += 1
    return st


@pytest.fixture(scope="module")
def uninterrupted():
    solver = _solver()
    return solver.solve(params=2.0)


def _same(a, b):
    return (a.status == b.status and a.iter == b.iter
            and a.counters == b.counters and a.objective == b.objective
            and np.array_equal(a.solution, b.solution)
            and np.array_equal(a.multipliers, b.multipliers))


@pytest.mark.parametrize("after,phase", [(4, S.REGULAR), (23, S.ROBUST)])
def test_resume_equals_the_uninterrupted_solve(after, phase, uninterrupted,
                                               tmp_path):
    first = _solver()
    st = _steps(first, first.kernel.initialize(first._params(2.0)), after)
    assert st.status == int(phase)
    path = str(tmp_path / "state.npz")
    save_state(st, path)

    second = _solver()
    st2 = resume(second, path)
    assert st2.k == st.k and torch.equal(st2.x, st.x)
    assert torch.equal(st2.RR.pp, st.RR.pp) and st2.RR.mu_R == st.RR.mu_R
    st2 = _steps(second, st2)
    assert st2.status == int(S.INFEASIBLE_PROBLEM_DETECTED)
    assert _same(second._stats(st2, 0.0), uninterrupted)


def test_solve_after_resume_warm_starts(tmp_path):
    first = _solver()
    first.solve(params=1.0)
    path = str(tmp_path / "solved.npz")
    save_state(first.state, path)
    warm = first.solve(params=1.05)

    second = _solver()
    resume(second, path)
    again = second.solve(params=1.05)
    assert again.status == T.Status.SOLVE_SUCCEEDED
    assert _same(again, warm)
    assert float(second.state.theta) == 1.05


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    solver = _solver()
    st = _steps(solver, solver.kernel.initialize(solver._params(2.0)), 2)
    return solver, state_arrays(st), tmp_path_factory.mktemp("strict")


def _write(arrays, folder, name):
    path = str(folder / name)
    np.savez(path, **arrays)
    return path


@pytest.mark.parametrize("case,field", [
    ("missing", "RR.pp"),
    ("extra", "bogus"),
    ("shape", "x"),
    ("dtype", "x"),
])
def test_load_is_strict(case, field, saved):
    solver, arrays, folder = saved
    arrays = dict(arrays)
    if case == "missing":
        del arrays[field]
    elif case == "extra":
        arrays[field] = np.zeros(3)
    elif case == "shape":
        arrays[field] = arrays[field][:-1]
    else:
        arrays[field] = arrays[field].astype(np.float32)
    path = _write(arrays, folder, f"{case}.npz")
    template = solver.kernel.zero_state(solver._params(None))
    with pytest.raises(ValueError, match=field):
        load_state(path, template)


def test_load_takes_the_template_device_and_dtype(saved):
    solver, arrays, folder = saved
    path = _write(arrays, folder, "whole.npz")
    st = load_state(path, solver.kernel.zero_state(solver._params(None)))
    assert st.x.dtype == torch.float64 and st.x.device.type == "cpu"
    assert isinstance(st.mu, float) and isinstance(st.k, int)
    assert isinstance(st.rr_init_needed, bool)
    assert state_arrays(st).keys() == arrays.keys()
    for k, v in state_arrays(st).items():
        assert np.array_equal(v, arrays[k]) and v.dtype == arrays[k].dtype, k
