"""The port's step options against the JAX package, on the CPU: the
adaptive barriers' whole solves here, and the helpers and case tables of
the other ``tests/test_torch_step_options_*.py`` files, which import them.
One file per subject:

* here — the quality-function and LOQO rules on ``hs15.build(x0=(1, 1))``
  and ``dummy_qp.build(20, 5)``, and the quality function on
  ``dummy_qp.build(30, 8)`` (tests/test_barrier.py);
* ``_barrier_units`` — the quality function and LOQO on a JAX state
  carried across by ``state_from_arrays``;
* ``_k25`` — the K2.5 scaling (tests/test_k25.py);
* ``_linear`` — the linear-solve options: FREE and IGNORE on the banded
  nb=14 ACOPF, AUTO with LU and QR on hs15, GMRES;
* ``_qn`` and ``_lbfgs`` — the quasi-Newton whole solves
  (tests/test_quasi_newton.py), dense and compact L-BFGS;
* ``_updates`` — the quasi-Newton updates and the SMW payload against the
  JAX functions on seeded inputs;
* ``_checkpoint`` — checkpoints under the step options.

``solve_batch``'s refusal of each step option and full-memory BFGS on a
sparse model are in tests/test_torch_solver.py, the σ-initialization
``curvature`` in tests/test_torch_ipm_kernels.py.

Each file whose tests run JAX reference solves holds at most six tests:
pytest-xdist's ``loadfile`` scheduler queues files by test count, largest
first, so these run beside the suite's long last file
(tests/test_batch.py, six tests) instead of before it.  The replay of a
measured Tier-1 trace (``tools/tier1_schedule.py simulate``) ends 130 s
later when the same tests sit in four files of 6-20 tests, and 14 s
later when one file holds ten.

Whole solves are held to the JAX package on the same model and options:
the status, iteration count and ``factorization_cnt`` exactly, the
objective within 1e-8 relative, and ``backsolve_cnt`` exactly (float64),
within 6% (float32, the ROADMAP rule), or within the one-ulp spread of
both packages where a study shows rounding moves it
(``tools/step_options_spread.py``, named at each spread).
"""

import numpy as np
import pytest
import torch

import madnlp_tpu as J
from madnlp_tpu.models.instances import dummy_qp as jdqp
from madnlp_tpu.models.instances import hs15 as jhs15

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import dummy_qp as tdqp
from madnlp_tpu_torch.models.instances import hs15 as ths15

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
BACKSOLVE_RTOL = 0.06


def enum_of(pkg, name):
    """An option value of the package ``pkg`` (J or T) by its name,
    ``"BarrierUpdate.LOQO"``."""
    enum, member = name.split(".")
    return getattr(getattr(pkg, enum), member)


def options(pkg, opts):
    """``opts`` with each ``"Enum.MEMBER"`` string as ``pkg``'s member."""
    return {k: enum_of(pkg, v) if isinstance(v, str) and "." in v else v
            for k, v in opts.items()}


def solve_both(jbuild, tbuild, opts):
    """The JAX package's and the port's solve of one case (the port on the
    CPU, both quiet)."""
    j = J.madnlp(jbuild(), print_level=J.PrintLevel.ERROR,
                 **options(J, opts))
    t = T.madnlp(tbuild(), device="cpu", print_level=T.PrintLevel.ERROR,
                 **options(T, opts))
    return j, t


def assert_same(t, j, backsolves=None):
    """Status, iterations and factorizations exactly, the objective within
    ``OBJ_RTOL``; ``backsolves``: None (exactly), "rtol" (within
    ``BACKSOLVE_RTOL``) or a (lo, hi) one-ulp spread of both packages."""
    assert t.status.name == j.status.name
    assert t.iter == j.iter
    assert t.counters["factorization_cnt"] == j.counters["factorization_cnt"]
    tb, jb = t.counters["backsolve_cnt"], j.counters["backsolve_cnt"]
    if backsolves is None:
        assert tb == jb
    elif backsolves == "rtol":
        assert abs(tb - jb) <= BACKSOLVE_RTOL * jb
    else:
        assert backsolves[0] <= tb <= backsolves[1]
        assert backsolves[0] <= jb <= backsolves[1]
    assert abs(t.objective - j.objective) <= OBJ_RTOL * max(abs(j.objective),
                                                            1e-300)


UNIT_RTOL = 1e-12


def close(t, j, what=""):
    """A port tensor (or float) and a JAX array within ``UNIT_RTOL``: the
    same float64 formulas, summed in another order."""
    j = np.asarray(j)
    t = t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=UNIT_RTOL,
                               atol=UNIT_RTOL * max(np.abs(j).max(), 1e-300),
                               err_msg=what)


def secant_pairs(n, count, seed):
    """Seeded secant pairs (s, y) with sᵀy > 0, except pair 3 (sᵀy < 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        s = rng.standard_normal(n)
        y = s * rng.uniform(0.5, 2.0, n) + 0.1 * rng.standard_normal(n)
        out.append((s, -y if i == 3 else y))
    return out


QF = {"barrier": "BarrierUpdate.QUALITY_FUNCTION"}
LOQO = {"barrier": "BarrierUpdate.LOQO"}
BARRIER_CASES = {
    "hs15_quality_function": (lambda: jhs15.build(x0=(1.0, 1.0)),
                              lambda: ths15.build(x0=(1.0, 1.0)), QF),
    "hs15_loqo": (lambda: jhs15.build(x0=(1.0, 1.0)),
                  lambda: ths15.build(x0=(1.0, 1.0)), LOQO),
    "dummy_qp_quality_function": (lambda: jdqp.build(20, 5),
                                  lambda: tdqp.build(20, 5), QF),
    "dummy_qp_loqo": (lambda: jdqp.build(20, 5), lambda: tdqp.build(20, 5),
                      LOQO),
    "dummy_qp30_quality_function": (lambda: jdqp.build(30, 8),
                                    lambda: tdqp.build(30, 8), QF),
}


@pytest.mark.parametrize("name", sorted(BARRIER_CASES))
def test_adaptive_barrier_solve_matches_jax(name):
    j, t = solve_both(*BARRIER_CASES[name])
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert_same(t, j)
