"""The step options inside ``solve_batch`` against the JAX package, on the
CPU (helpers and rules in tests/test_torch_batch_options.py): compact
L-BFGS (a memory and a low-rank Hessian per lane, its SMW payload one
batched backsolve of 2p columns per factorization), the K2.5 scaling in
float32 and as ``kkt_system="scaled_sparse"``, and GMRES refinement.

GMRES runs as GMRES inside the batch: the JAX package's sparse KKT
system inherits ``solve_refine`` from its dense one, which reads
``iterator``, so its single solves of this model count 10 backsolves per
factorization (110, 110, 100), against 11-12 under Richardson; each lane
of the port's batch is held to those single solves.

And one batched compact L-BFGS step from the JAX package's states after
two regular steps (the step refreshes each lane's Hessian from its
secant pair), against the JAX step of each lane: counters exactly, the
iterate within 1e-9 relative, each lane's memory and low-rank Hessian
within 1e-9 relative.
"""

import pytest
import torch

from test_torch_batch_options import (
    _rel,
    STEP_RTOL,
    assert_lanes_match,
    assert_step_matches,
    batched_step_from_jax,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["compact_lbfgs", "k25_float32",
                                  "scaled_sparse", "gmres"])
def test_batch_lanes_match_jax(name):
    summ = assert_lanes_match(name)
    c = summ["counters"]
    if name == "compact_lbfgs":
        assert (c["hess_cnt"] == 0).all()
    if name == "gmres":
        # max_iter backsolves per factorization, as the JAX package counts
        assert (c["backsolve_cnt"] == 10 * c["factorization_cnt"]).all()


def test_batched_lbfgs_step_from_jax_states():
    tst, jnext = batched_step_from_jax("compact_lbfgs", 2)
    assert_step_matches(tst, jnext, ("x", "y", "zl", "zu", "mu", "alpha",
                                     "obj_val"))
    for i, js in enumerate(jnext):
        assert tst.qn.mem[i] == int(js.qn.mem) > 0
        assert tst.qn.skipped[i] == int(js.qn.skipped)
        for f in ("Sk", "Yk", "last_x", "last_g"):
            assert _rel(getattr(tst.qn, f)[i], getattr(js.qn, f)) \
                < STEP_RTOL, (i, f)
        for f in ("diag", "U", "V"):
            assert _rel(getattr(tst.hess, f)[i], getattr(js.hess, f)) \
                < STEP_RTOL, (i, f)
