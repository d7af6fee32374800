"""The K2.5 scaling against the JAX package (the cases of
tests/test_k25.py; helpers in tests/test_torch_step_options.py):
``kkt_scaling="k25"`` on ``dummy_qp.build(20, 5)`` (the condensed default,
which the K2.5 scaling leaves unscaled), ``kkt_system="scaled_sparse"`` on
it (the SPARSE system under K2.5), ``kkt_scaling="none"`` on
``hs15.build()``, and the JAX package's float32 ACOPF recipe,
``opf.build_sparse(nb=60, seed=0)`` on SPARSE in float32 under K2.5
(backsolves within 6%; the dual infeasibility below 1e-8, as the reference
test asserts); and that ``kkt_system="scaled_sparse"`` resolves to SPARSE
under K2.5."""

import pytest

from madnlp_tpu.models.instances import dummy_qp as jdqp
from madnlp_tpu.models.instances import hs15 as jhs15
from madnlp_tpu.models.instances import opf as jopf

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import dummy_qp as tdqp
from madnlp_tpu_torch.models.instances import hs15 as ths15
from madnlp_tpu_torch.models.instances import opf as topf

from test_torch_step_options import assert_same, solve_both

CASES = {
    "dummy_qp_k25": (lambda: jdqp.build(20, 5), lambda: tdqp.build(20, 5),
                     {"kkt_scaling": "k25"}),
    "dummy_qp_scaled_sparse": (lambda: jdqp.build(20, 5),
                               lambda: tdqp.build(20, 5),
                               {"kkt_system": "scaled_sparse"}),
    "hs15_no_scaling": (jhs15.build, ths15.build, {"kkt_scaling": "none"}),
    "opf60_k25_float32": (
        lambda: jopf.build_sparse(nb=60, seed=0),
        lambda: topf.build_sparse(nb=60, seed=0),
        {"kkt_system": "sparse", "dtype": "float32", "kkt_scaling": "k25",
         "max_iter": 100}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_k25_solve_matches_jax(name):
    jbuild, tbuild, opts = CASES[name]
    j, t = solve_both(jbuild, tbuild, opts)
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert_same(t, j, "rtol" if opts.get("dtype") == "float32" else None)
    if opts.get("dtype") == "float32":
        assert t.dual_feas < 1e-8


def test_scaled_sparse_is_the_k25_sparse_system():
    """``kkt_system="scaled_sparse"`` resolves to SPARSE with
    ``kkt_scaling="k25"`` (the JAX package's alias, solver.py:77-83)."""
    a = T.MadNLPSolver(tdqp.build(20, 5), device="cpu",
                       kkt_system="scaled_sparse")
    assert a.opts.kkt_system == T.KKTSystem.SPARSE
    assert a.opts.kkt_scaling == "k25"
