"""The inertia-free and inertia-ignoring corrections inside ``solve_batch``
and in the single solve, against the JAX package, on the CPU (helpers and
rules in tests/test_torch_batch_options.py).

The batch of the parametric ``opf.build_sparse(nb=14, seed=0,
parametric=True)`` at load scales (0.95, 1.0, 1.05) under FREE and under
IGNORE, every lane held to the JAX package's single solve of its scale
and to the port's own.  And the port's single solve of the plain
``opf.build_sparse(nb=14, seed=0)``, banded, under each strategy, held to
the JAX package's solve at scale 1.0 of the same JAX solver: the
parametric model at scale 1.0 is the plain one (the port's
tests/test_torch_batch.py holds its two solves equal; the JAX package's
two solves give the same status, counts and objective under both
strategies).  Its backsolves are held to the one-ulp spread of both
packages (``tools/spread.py inertia --pkg both --option free|ignore``:
seven runs each, as they are and moved by at most one ulp): the solve
ends with one Richardson sweep more or less than the JAX package's at its
last factorization (μ = 2.5e-9), as the default inertia-based solve of
that model does, where the refinement's ratio sits on its tolerance
(FREE 22-23 backsolves, IGNORE 11-12).
"""

import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf as topf

from test_torch_batch_options import SCALES, assert_lanes_match, jax_reference
from test_torch_step_options import assert_same

torch.set_num_threads(1)

BACKSOLVE_SPREAD = {"FREE": (22, 23), "IGNORE": (11, 12)}


@pytest.mark.parametrize("name", ["inertia_free", "inertia_ignore"])
def test_batch_lanes_match_jax(name):
    summ = assert_lanes_match(name)
    # the nb=14 ACOPF needs no δ regularization
    assert (summ["counters"]["factorization_cnt"] == summ["iter"]).all()


@pytest.mark.parametrize("method", ["FREE", "IGNORE"])
def test_inertia_strategy_on_the_banded_path_matches_jax(method):
    _, jstats = jax_reference(f"inertia_{method.lower()}")
    j = jstats[SCALES.index(1.0)]
    t = T.madnlp(topf.build_sparse(nb=14, seed=0), device="cpu",
                 print_level=T.PrintLevel.ERROR,
                 linear_solver=T.LinearSolver.BANDED,
                 inertia_correction_method=getattr(T.InertiaCorrection,
                                                   method))
    assert t.status == T.Status.SOLVE_SUCCEEDED
    assert_same(t, j, BACKSOLVE_SPREAD[method])
