"""The KKT systems of slice A4 below a whole solve, against the JAX
package's on the same inputs: ``SparseUnreducedKKT`` (banded and on
dense storage), ``DenseUnreducedKKT``, ``SparseCondensedKKT`` (banded and on
dense storage), and the range-space solvers threaded through ``DenseKKT``
(``split``, ``rr``).

Each case builds both packages' solvers for the same model and options
(``opf.build_sparse(nb=14)``, or the dense ``opf.build(nb=14)``), draws one
KKT context's inputs by numpy from a seed (Hessian and Jacobian values,
positive slacks and bound duals, a regularization) and calls
``build_and_factorize``, ``inertia``, ``solve`` on a seeded right-hand
side, ``mul`` (the refinement operator) on that solution and
``mul_hess_blk``, each held to the JAX package's result within 1e-12
relative (float64); the JAX package's calls run in one ``jax.jit`` per
case (compiled at XLA's backend optimization level 0: the same program,
its results within rounding of the default build's, at about half the
backend compile time, for the slice's test budget), and no solve runs.

``mul`` of the condensed and unreduced systems is the operator the
refinement runs against: the JAX package gates its banded operator on
``_band_is_augmented``, so these systems apply the sparse products, and the
port's must equal them (the port's banded path once took the stored band
for every system).  The condensed band's pair records (``a ≤ b``, weight 2
on a duplicate-record diagonal pair) and the dense path's ordered records
equal the JAX package's.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf as topf

torch.set_num_threads(1)

RTOL = 1e-12

CASES = {
    "unreduced_banded": ("sparse", dict(kkt_system="sparse_unreduced",
                                        linear_solver="banded")),
    "unreduced_dense_storage": ("sparse", dict(kkt_system="sparse_unreduced",
                                               linear_solver="ldl")),
    "unreduced_dense_model": ("dense", dict(kkt_system="sparse_unreduced",
                                            linear_solver="ldl")),
    "condensed_banded": ("sparse", dict(kkt_system="sparse_condensed",
                                        linear_solver="banded")),
    "condensed_dense_storage": ("sparse", dict(kkt_system="sparse_condensed",
                                               linear_solver="cholesky")),
    # DenseKKT's split and rr (BLOCK_CHOLESKY takes the same split; its
    # factor is held in tests/test_torch_range_space.py): HYKKT on the
    # model's KKT system, its CG solve and its rr mode's direct solve
    "dense_hykkt": ("dense", dict(kkt_system="dense", linear_solver="hykkt",
                                  hykkt_backend="ldl")),
    "dense_hykkt_rr": ("dense", dict(kkt_system="dense",
                                     linear_solver="hykkt",
                                     hykkt_backend="ldl")),
}


def _solvers(kind, opts):
    import madnlp_tpu as J
    from madnlp_tpu.models.instances import opf as jopf

    build = "build_sparse" if kind == "sparse" else "build"
    js = J.MadNLPSolver(getattr(jopf, build)(nb=14, seed=0),
                        print_level="error", **opts)
    ts = T.MadNLPSolver(getattr(topf, build)(nb=14, seed=0), device="cpu",
                        print_level="error", **opts)
    return js, ts


def _inputs(ts, seed):
    """One context's inputs: (JAX arrays, torch tensors)."""
    p = ts.prob
    rng = np.random.default_rng(seed)
    hess = rng.standard_normal(tuple(p.hess_template().shape)) * 0.1
    if hess.ndim == 2:
        hess = (hess + hess.T) / 2
    jac = rng.standard_normal(tuple(p.jac_template().shape))
    if jac.ndim == 1:
        jac[len(p.model.jac_rows):] = -1.0      # the slack entries
    # a well-conditioned context (W + Σ ≻ 0, a moderate dual diagonal): the
    # comparison is of structure, not of rounding amplified by conditioning
    reg = np.full(p.nw, 2.0)
    du_diag = np.full(p.m, -0.5)
    dl, du_, zl, zu = (rng.uniform(0.5, 2.0, p.nw) for _ in range(4))
    args = [hess, jac, reg, du_diag, dl, du_, zl, zu]
    import jax.numpy as jnp
    return ([jnp.asarray(a) for a in args],
            [torch.as_tensor(a) for a in args])


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-300)
    err = np.abs(a - b).max() / scale
    assert err <= RTOL, f"{what}: relative error {err:.3e}"


def _vec(rng, p):
    return [rng.standard_normal(p.nw), rng.standard_normal(p.m),
            rng.standard_normal(p.nw), rng.standard_normal(p.nw)]


def _jax_run(jk, jargs, rr, b, v, t):
    """The JAX package's inertia, solve, operator and Hessian block of one
    context, in one ``jax.jit``."""
    import jax
    import jax.numpy as jnp
    from madnlp_tpu.kkt.vec import KKTVec as JV

    def run(args, b, v, t):
        ctx = jk.build_and_factorize(*args, rr=rr)
        inertia = jnp.stack([jnp.asarray(i, jnp.int64)
                             for i in jk.inertia(ctx)])
        return (inertia, jk.solve(ctx, JV(*b)), jk.mul(ctx, JV(*v)),
                jk.mul_hess_blk(ctx, t))

    args = (jargs, [jnp.asarray(a) for a in b],
            [jnp.asarray(a) for a in v], jnp.asarray(t))
    return jax.jit(run).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_kkt_matches_jax(case):
    from madnlp_tpu_torch.kkt.vec import KKTVec as TV

    kind, opts = CASES[case]
    js, ts = _solvers(kind, opts)
    jk, tk = js.kernel.kkt, ts.kernel.kkt
    assert type(jk).__name__ == type(tk).__name__
    assert tk.solver.name == jk.solver.name
    jargs, targs = _inputs(ts, 1)
    rr = case.endswith("_rr")
    rng = np.random.default_rng(2)
    b, v = _vec(rng, ts.prob), _vec(rng, ts.prob)
    t = rng.standard_normal(ts.prob.nw)
    ji, jx, jm, jh = _jax_run(jk, jargs, rr, b, v, t)
    tctx = tk.build_and_factorize(*targs, rr=rr)
    assert tuple(int(i) for i in np.asarray(ji)) == tuple(tk.inertia(tctx))
    if "condensed" in case or "unreduced" in case:
        assert tctx.factor.opband is None
    tx = tk.solve(tctx, TV(*[torch.as_tensor(a) for a in b]))
    # the refinement operator
    tm = tk.mul(tctx, TV(*[torch.as_tensor(a) for a in v]))
    for f in ("xp", "y", "zl", "zu"):
        _close(getattr(tx, f).numpy(), getattr(jx, f), f"solve.{f}")
        _close(getattr(tm, f).numpy(), getattr(jm, f), f"mul.{f}")
    _close(tk.mul_hess_blk(tctx, torch.as_tensor(t)).numpy(), jh,
           "mul_hess_blk")
    if "hykkt" in case:
        assert tctx.factor.inner.meta[2] is rr


def _records(k, names, to_np):
    r = np.stack([to_np(getattr(k, n)) for n in names])
    return r[:, np.lexsort(r[::-1])]


def test_condensed_pair_records_match_jax():
    """The banded condensed system's pair records and weights, and the
    dense path's ordered records, are the JAX package's: the same set (the
    JAX package's native symbolic module emits them in another order than
    its numpy version, which the port copies; every sum over them is a sum
    over the set)."""
    js, ts = _solvers("sparse", CASES["condensed_banded"][1])
    jk, tk = js.kernel.kkt, ts.kernel.kkt
    band = ("bpair_a", "bpair_b", "bpair_k", "bpair_w")
    np.testing.assert_array_equal(_records(tk, band, lambda v: v.numpy()),
                                  _records(jk, band, np.asarray))
    assert float(tk.bpair_w.max()) == 2.0     # duplicate-record diagonals
    np.testing.assert_array_equal(tk.bstruct.perm, jk.bstruct.perm)
    js, ts = _solvers("sparse", CASES["condensed_dense_storage"][1])
    jk, tk = js.kernel.kkt, ts.kernel.kkt
    dense = ("pair_a", "pair_b", "pair_k")
    np.testing.assert_array_equal(_records(tk, dense, lambda v: v.numpy()),
                                  _records(jk, dense, np.asarray))


def test_unreduced_refuses_a_low_rank_hessian():
    with pytest.raises(ValueError, match="low-rank"):
        T.MadNLPSolver(topf.build_sparse(nb=14, seed=0), device="cpu",
                       kkt_system="sparse_unreduced",
                       hessian_approximation="compact_lbfgs")
