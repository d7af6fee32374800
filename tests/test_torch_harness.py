"""The port's shipped test harness (madnlp_tpu_torch/testing.py) on the CPU:
its contracts must hold on every linear solver and KKT system the port
has, and its behavior suite must pass (its checks are the JAX package's,
with the same reference solutions; no JAX solve runs here).

* ``test_linear_solver`` for LDL (K7's plain version here), CHOLESKY, LU,
  QR, EVD, BLOCK_CHOLESKY and HYKKT (slice A4: the quasidefinite 3×3
  system split at 2; until A4 these two cases, and the A4 systems of
  ``test_kkt_contract``, were tests that asserted the raise).
* ``test_kkt_system`` — the round trip ``K·solve(1) ≈ 1`` through the
  unreduced operator and the inertia under unit regularization — on
  DENSE (LDL, EVD), DENSE_CONDENSED (Cholesky, LDL), SPARSE on dense
  storage (a dense model; a sparse model under LDL), SPARSE banded
  (K1/K2's plain versions; float32 held to 1e-5, a float32 factor without
  refinement), SCALED_SPARSE (K2.5) and a custom model
  (``dummy_qp.build(16, 4)``); since slice A4 also SPARSE_UNREDUCED (LDL
  storage of a dense model, and banded and LDL storage of a sparse one),
  SPARSE_CONDENSED (its Cholesky preset, and banded), DENSE under
  BLOCK_CHOLESKY and HYKKT, and SPARSE on dense storage under HYKKT.
* ``run_behavior_suite(device="cpu", exclude=("eigmina",))`` returns the
  JAX test's set of names (tests/test_testing_harness.py).
* ``MadNLPSolver.solve_jitted`` equals a cold ``solve()`` bit for bit.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
import madnlp_tpu_torch.testing as mt
from madnlp_tpu_torch.models.instances import dummy_qp, hs15, sparse_qp
from madnlp_tpu_torch.utils.options import KKTSystem, LinearSolver

torch.set_num_threads(1)


@pytest.mark.parametrize("solver", [
    LinearSolver.LDL, LinearSolver.CHOLESKY, LinearSolver.LU,
    LinearSolver.QR, LinearSolver.EVD, LinearSolver.BLOCK_CHOLESKY,
    LinearSolver.HYKKT])
def test_linear_solver_contract(solver):
    assert mt.test_linear_solver(solver, device="cpu")


KKT_CASES = {
    "dense_ldl": (None, KKTSystem.DENSE, LinearSolver.LDL, {}),
    "dense_evd": (None, KKTSystem.DENSE, LinearSolver.EVD, {}),
    "condensed_cholesky": (None, KKTSystem.DENSE_CONDENSED, None, {}),
    "condensed_ldl": (None, KKTSystem.DENSE_CONDENSED, LinearSolver.LDL, {}),
    "sparse_dense_model": (None, KKTSystem.SPARSE, LinearSolver.LDL, {}),
    "sparse_dense_storage": ("qp", KKTSystem.SPARSE, LinearSolver.LDL, {}),
    "sparse_banded": ("qp", KKTSystem.SPARSE, LinearSolver.BANDED, {}),
    # a float32 factor without refinement: the round trip to 1e-5
    "sparse_banded_f32": ("qp", KKTSystem.SPARSE, LinearSolver.BANDED,
                          {"dtype": "float32", "rtol": 1e-5}),
    "scaled_sparse": ("qp", KKTSystem.SCALED_SPARSE, LinearSolver.BANDED, {}),
    "custom_model": ("dummy16", None, None, {}),
    # slice A4
    "unreduced_dense_model": (None, KKTSystem.SPARSE_UNREDUCED,
                              LinearSolver.LDL, {}),
    "unreduced_banded": ("qp", KKTSystem.SPARSE_UNREDUCED,
                         LinearSolver.BANDED, {}),
    "unreduced_dense_storage": ("qp", KKTSystem.SPARSE_UNREDUCED,
                                LinearSolver.LDL, {}),
    "condensed_sparse_preset": ("qp", KKTSystem.SPARSE_CONDENSED, None, {}),
    "condensed_banded": ("qp", KKTSystem.SPARSE_CONDENSED,
                         LinearSolver.BANDED, {}),
    "dense_block_cholesky": (None, KKTSystem.DENSE,
                             LinearSolver.BLOCK_CHOLESKY, {}),
    "dense_hykkt": (None, KKTSystem.DENSE, LinearSolver.HYKKT, {}),
    "dense_hykkt_ldl": (None, KKTSystem.DENSE, LinearSolver.HYKKT,
                        {"hykkt_backend": "ldl"}),
    "sparse_dense_storage_hykkt": ("qp", KKTSystem.SPARSE, LinearSolver.HYKKT,
                                   {}),
}


def _model(name):
    if name == "qp":
        return sparse_qp.build(n=60, m=15)
    if name == "dummy16":
        return dummy_qp.build(16, 4)
    return None


@pytest.mark.parametrize("case", sorted(KKT_CASES))
def test_kkt_contract(case):
    model, kkt, lin, opts = KKT_CASES[case]
    if lin == LinearSolver.BANDED:
        solver = T.MadNLPSolver(_model(model), device="cpu", kkt_system=kkt,
                                linear_solver=lin, dtype=opts.get("dtype",
                                                                  "float64"))
        assert solver.kernel.kkt.banded
    assert mt.test_kkt_system(model=_model(model), kkt_system=kkt,
                              linear_solver=lin, device="cpu", **opts)


def test_behavior_suite_default():
    results = mt.run_behavior_suite(device="cpu", exclude=("eigmina",))
    assert set(results) == {"hs15", "lootsma", "infeasible", "unbounded",
                            "lp_issue75", "bound_qp", "cops_chain",
                            "cops_elec"}


@pytest.mark.parametrize("model", ["hs15", "sparse_qp_banded"])
def test_solve_jitted_equals_solve(model):
    def solver():
        if model == "hs15":
            return T.MadNLPSolver(hs15.build(), device="cpu",
                                  print_level="ERROR")
        return T.MadNLPSolver(sparse_qp.build(n=60, m=15), device="cpu",
                              linear_solver=LinearSolver.BANDED,
                              print_level="ERROR")
    a, b = solver().solve(), solver().solve_jitted()
    assert a.status == b.status and a.counters == b.counters
    assert a.objective == b.objective
    for f in ("solution", "multipliers", "multipliers_L", "multipliers_U",
              "constraints"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
