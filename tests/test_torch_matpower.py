"""Parity of the port's MATPOWER front end (madnlp_tpu_torch/models/
matpower.py) with the JAX package's (madnlp_tpu/models/matpower.py) on the
same inputs: parsed cases, per-unit arrays, tiled and interconnected
systems, and the ACOPF callbacks at seeded points.

The parser, ``_prepare`` and the case builders are host-side numpy in both
packages, so their outputs are held exactly.  The sparse callbacks are
held to 1e-12 normwise relative (the port's branch derivatives are closed
forms, the JAX package's ``vmap(jacfwd)``/``vmap(hessian)``: rounding
only), with the COO coordinates exact; the dense callbacks, closed-form
and ``torch.func``, to 1e-10.  Whole solves are in
tests/test_torch_matpower_solve.py.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madnlp_tpu.models import matpower as jm
from madnlp_tpu_torch.models import matpower as tm

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
CASES = ["case5", "case9", "case14", "case30", "case57", "case118"]
SPARSE_RTOL = 1e-12
DENSE_RTOL = 1e-10


def _path(name):
    return os.path.join(DATA, f"{name}.m")


def _assert_same(a, b):
    """Two dicts of the case builders equal: keys, arrays exactly (dtype
    and values), lists and scalars."""
    assert set(a) == set(b)
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray) and va.dtype == vb.dtype, k
            np.testing.assert_array_equal(va, vb, err_msg=k)
        else:
            assert va == vb, k


def _rel(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300)


@pytest.mark.parametrize("name", CASES)
def test_parse_and_prepare_match(name):
    tc, jc = tm.parse_case(_path(name)), jm.parse_case(_path(name))
    _assert_same(tc, jc)
    _assert_same(tm._prepare(tc), jm._prepare(jc))
    np.testing.assert_array_equal(tm._branch_consts(tm._prepare(tc)),
                                  jm._branch_consts(jm._prepare(jc)))


def test_parse_case_from_text():
    with open(_path("case9")) as f:
        text = f.read()
    _assert_same(tm.parse_case(text), jm.parse_case(text))
    with pytest.raises(ValueError, match="missing mpc"):
        tm.parse_case("function mpc = broken\nmpc.baseMVA = 100;\n")


@pytest.mark.parametrize("K,ties,n_tie", [(4, None, 3), (4, "ring", 3),
                                          (2, "ring", 3), (4, "grid2d", 3),
                                          (6, "grid2d", 2)])
def test_tile_case_matches(K, ties, n_tie):
    case = jm.parse_case(_path("case118"))
    tc = tm.tile_case(case, K, ties=ties, n_tie=n_tie)
    jc = jm.tile_case(case, K, ties=ties, n_tie=n_tie)
    _assert_same(tc, jc)
    _assert_same(tm._prepare(tc), jm._prepare(jc))


@pytest.mark.parametrize("ties", [None, "chain"])
def test_interconnect_cases_matches(ties):
    # case5's branch table is as wide as the others: pad case9's to test
    # the defaults of padded columns
    cases = [jm.parse_case(_path(n)) for n in ("case9", "case57", "case118")]
    cases[0] = dict(cases[0], branch=cases[0]["branch"][:, :10])
    tc = tm.interconnect_cases(cases, ties=ties)
    jc = jm.interconnect_cases(cases, ties=ties)
    _assert_same(tc, jc)
    _assert_same(tm._prepare(tc), jm._prepare(jc))


def test_bad_costs_rejected():
    case = tm.parse_case(_path("case5"))
    case["gencost"][0][0] = 1  # piecewise-linear model
    with pytest.raises(ValueError, match="polynomial"):
        tm.build_acopf(case)
    case = tm.parse_case(_path("case5"))
    # neither norig nor 2*norig rows
    case["gencost"] = case["gencost"] + case["gencost"][:1]
    with pytest.raises(ValueError, match="gencost"):
        tm._prepare(case)
    with pytest.raises(ValueError, match="parametric"):
        tm.build_acopf(tm.parse_case(_path("case5")), sparse=False,
                       parametric=True)


def _case(spec):
    name, _, tile = spec.partition("x4")
    case = jm.parse_case(_path(name))
    return jm.tile_case(case, 4, ties="ring") if tile == "_ring" else case


def _point(model, seed):
    rng = np.random.default_rng(seed)
    x = model.x0 + 0.05 * rng.standard_normal(model.n)
    y = rng.standard_normal(model.m)
    return x, y, 0.7


@pytest.mark.parametrize("spec,parametric", [("case30", False),
                                             ("case118", False),
                                             ("case118x4_ring", False),
                                             ("case30", True)])
def test_sparse_callbacks_match(spec, parametric):
    case = _case(spec)
    jmod = jm.build_acopf(case, sparse=True, parametric=parametric)
    tmod = tm.build_acopf(case, sparse=True, parametric=parametric)
    assert (tmod.n, tmod.m, tmod.name) == (jmod.n, jmod.m, jmod.name)
    for a in ("jac_rows", "jac_cols", "hess_rows", "hess_cols", "x0",
              "lvar", "uvar", "lcon", "ucon"):
        np.testing.assert_array_equal(getattr(tmod, a), getattr(jmod, a),
                                      err_msg=a)
    x, y, ow = _point(jmod, tmod.n)
    jp = (jnp.asarray(0.95),) if parametric else ()
    tp = (torch.tensor(0.95, dtype=torch.float64),) if parametric else ()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    pairs = {
        "obj": (tmod.obj(tx, *tp), jax.jit(jmod.obj)(jx, *jp)),
        "grad": (tmod.grad(tx, *tp), jax.jit(jax.grad(jmod.obj))(jx, *jp)),
        "cons": (tmod.cons(tx, *tp), jax.jit(jmod.cons)(jx, *jp)),
        "jac": (tmod.jac_coords(tx, *tp), jax.jit(jmod.jac_coords)(jx, *jp)),
        "hess": (tmod.hess_coords(tx, ty, ow, *tp),
                 jax.jit(jmod.hess_coords)(jx, jy, ow, *jp)),
    }
    for k, (t, j) in pairs.items():
        assert _rel(t, j) < SPARSE_RTOL, k
    # bus sums are contributor gathers: the same bits on every call
    assert torch.equal(tmod.cons(tx, *tp), tmod.cons(tx, *tp))


def test_sparse_callbacks_broadcast_over_lanes():
    """solve_batch evaluates a parametric model on (B, n) points with (B,)
    scales and a (B, 1) objective weight: lane b equals the single call."""
    case = jm.parse_case(_path("case30"))
    tmod = tm.build_acopf(case, sparse=True, parametric=True)
    pts = [_point(tmod, s) for s in range(3)]
    X = torch.as_tensor(np.stack([p[0] for p in pts]))
    Y = torch.as_tensor(np.stack([p[1] for p in pts]))
    S = torch.tensor([0.9, 1.0, 1.1], dtype=torch.float64)
    W = torch.tensor([[0.7], [1.0], [0.3]], dtype=torch.float64)
    for b in range(3):
        one = (X[b], Y[b], W[b, 0], S[b])
        for got, ref in (
                (tmod.cons(X, S)[b], tmod.cons(one[0], one[3])),
                (tmod.jac_coords(X, S)[b], tmod.jac_coords(one[0], one[3])),
                (tmod.hess_coords(X, Y, W, S)[b], tmod.hess_coords(*one)),
                (tmod.obj(X, S)[b], tmod.obj(one[0], one[3]))):
            assert _rel(got, ref) < SPARSE_RTOL


@pytest.mark.parametrize("name", ["case9", "case30"])
@pytest.mark.parametrize("analytic", [True, False])
def test_dense_callbacks_match(name, analytic):
    case = jm.parse_case(_path(name))
    jmod = jm.build_acopf(case, sparse=False, analytic=analytic)
    tmod = tm.build_acopf(case, sparse=False, analytic=analytic)
    assert (tmod.n, tmod.m, tmod.name) == (jmod.n, jmod.m, jmod.name)
    x, y, ow = _point(jmod, 1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    pairs = {
        "grad": (tmod.grad(tx), jax.jit(jmod.grad)(jx)),
        "cons": (tmod.cons(tx), jax.jit(jmod.cons)(jx)),
        "jac": (tmod.jac(tx), jax.jit(jmod.jac)(jx)),
        "lag_hess": (tmod.lag_hess(tx, ty, ow),
                     jax.jit(jmod.lag_hess)(jx, jy, ow)),
    }
    for k, (t, j) in pairs.items():
        assert _rel(t, j) < DENSE_RTOL, k


def test_dense_closed_forms_match_torch_func():
    """The closed-form dense derivatives against ``torch.func`` on the
    port's own model (case14: taps and a shifter-free Ybus)."""
    case = tm.parse_case(_path("case14"))
    ma = tm.build_acopf(case, sparse=False, analytic=True)
    mr = tm.build_acopf(case, sparse=False, analytic=False)
    x, y, ow = _point(ma, 2)
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    assert _rel(ma.jac(tx), mr.jac(tx)) < DENSE_RTOL
    assert _rel(ma.lag_hess(tx, ty, ow), mr.lag_hess(tx, ty, ow)) < DENSE_RTOL
