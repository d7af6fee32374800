"""Whole-solve parity of slice A4's remaining configurations with the JAX
package on the CPU (``slow``: one JAX compile each, 10-40 s apiece):
BLOCK_CHOLESKY, HYKKT with the ``"native"`` backend, and with the
``"ldl"`` one (K7's plain version) in the ``inverse`` solve mode and in
float32, on the dense ``opf.build(nb=14)`` (HYKKT ``"ldl"`` in float64 is
a ``slow`` case of tests/test_torch_a4_solves.py); HYKKT under
``DENSE_CONDENSED`` (the condensed matrix split at n, which the model's
equality rows keep); and ``SPARSE_CONDENSED`` with compact L-BFGS (the SMW
payload on the condensed band) on ``opf.build_sparse(nb=14)``.

Status, iterations and factorizations exactly and the objective within
1e-8 relative; backsolves exactly in float64 and within 6% in float32.
The condensed L-BFGS run is held to the status and the objective only:
the condensed system's counts are rounding's (ROADMAP §C, R3).

    python -m pytest tests/test_torch_a4_slow.py -q -m slow
"""

import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf as topf

torch.set_num_threads(1)

pytestmark = pytest.mark.slow

CASES = {
    "block_cholesky": ("build", dict(kkt_system="dense",
                                     linear_solver="block_cholesky")),
    "hykkt_native": ("build", dict(kkt_system="dense", linear_solver="hykkt",
                                   hykkt_backend="native")),
    "hykkt_inverse": ("build", dict(kkt_system="dense",
                                    linear_solver="hykkt",
                                    hykkt_backend="ldl",
                                    solve_mode="inverse")),
    "hykkt_float32": ("build", dict(kkt_system="dense",
                                    linear_solver="hykkt",
                                    hykkt_backend="ldl", dtype="float32")),
    "condensed_dense_hykkt": ("build", dict(kkt_system="dense_condensed",
                                            linear_solver="hykkt",
                                            hykkt_backend="ldl")),
    "sparse_condensed_lbfgs": ("build_sparse", dict(
        kkt_system="sparse_condensed", linear_solver="banded", tol=1e-6,
        hessian_approximation="compact_lbfgs")),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a4_configuration_matches_jax(name):
    import madnlp_tpu as J
    from madnlp_tpu.models.instances import opf as jopf

    build, opts = CASES[name]
    ref = J.madnlp(getattr(jopf, build)(nb=14, seed=0), print_level="error",
                   **opts)
    s = T.madnlp(getattr(topf, build)(nb=14, seed=0), device="cpu",
                 print_level="error", **opts)
    assert s.status == ref.status == T.Status.SOLVE_SUCCEEDED
    assert abs(s.objective - ref.objective) <= 1e-8 * abs(ref.objective)
    if name == "sparse_condensed_lbfgs":
        return
    assert s.iter == ref.iter
    c, rc = s.counters, ref.counters
    assert c["factorization_cnt"] == rc["factorization_cnt"]
    tol = 0.06 if opts.get("dtype") == "float32" else 0.0
    assert abs(c["backsolve_cnt"] - rc["backsolve_cnt"]) <= tol * rc[
        "backsolve_cnt"]
