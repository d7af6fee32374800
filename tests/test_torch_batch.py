"""The port's multi-scenario batched solve (``MadNLPSolver.solve_batch``)
and the plain versions of its batched band kernels, against the JAX
package, on the CPU.

* The plain batched factorize / solve (the plain versions of K3 / K4)
  against ``jax.vmap`` of the streaming Pallas kernels in interpret mode,
  which maps them onto the batch-grid kernels K3 / K4: real block columns
  and solutions within 1e-10 relative (float64; only summation order
  differs on these diagonally dominant systems), inertia exact per lane
  (lane 1 carries an exactly zero pivot), an inactive lane untouched.
* ``solve_batch`` of ``opf.build_sparse(nb=118, seed=0, parametric=True)``
  in float64 at load scales (0.95, 1.0, 1.05) against the JAX package's
  single parametric solves of each scale (the JAX package holds its own
  batch lanes equal to its single solves, tests/test_batch.py): status,
  iterations and factorizations exact — the lanes' δ-regularization
  ladders diverge (38 / 43 / 40 factorizations in 30 / 36 / 34
  iterations) — objective within 1e-8 relative, x within 1e-7,
  ``backsolve_cnt`` within one sweep per lane (the JAX package's own batch
  and single paths differ by one refinement sweep at nb=24 and nb=48).
* The chunked run (probe, sort, chunks, inverse permutation) against the
  bulk run; the batched initialize against the JAX ``initialize`` of each
  lane carried across with ``batch_state_from_arrays``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madnlp_tpu as J
from madnlp_tpu.models.instances import opf as jopf
from madnlp_tpu.ops import banded as jb
from madnlp_tpu.ops import pallas_banded_stream as jps
from madnlp_tpu.utils.options import RichardsonOptions as JRichardson

import madnlp_tpu_torch as T
from madnlp_tpu_torch.ipm.state import batch_state_from_arrays
from madnlp_tpu_torch.models.instances import opf as topf
from madnlp_tpu_torch.ops import banded as tb
from madnlp_tpu_torch.ops import banded_kernels as tk
from madnlp_tpu_torch.testing import band_system

torch.set_num_threads(1)

OBJ_RTOL = 1e-8
X_TOL = 1e-7
KERNEL_RTOL = 1e-10
SCALES = (0.95, 1.0, 1.05)


def _rel(a, ref):
    """Normwise relative difference; equal entries (infinite bounds
    included) count as zero."""
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        diff = np.where(a == ref, 0.0, np.abs(a - ref))
    scale = np.max(np.abs(ref[np.isfinite(ref)]), initial=0.0)
    return np.max(diff, initial=0.0) / max(scale, 1e-300)


# -- plain K3 / K4 against the JAX batch-grid kernels -------------------------


@pytest.fixture(scope="module")
def band_batch():
    """Three float64 band systems of one structure (N=96, b=32, bw=2): lane
    0 definite, lane 1 with an exactly zero pivot, lane 2 indefinite."""
    N, b, bw = 96, 32, 2
    # density 1: every lane has the full band, so one structure
    lanes = [band_system(11, N, b, bw, signs=False, density=1.0),
             band_system(12, N, b, bw, zero_row=40, density=1.0),
             band_system(13, N, b, bw, signs=True, density=1.0)]
    rows, cols = lanes[0][0], lanes[0][1]
    assert all((r == rows).all() and (c == cols).all() for r, c, _ in lanes)
    perm = np.arange(N)
    js = jb.BandStructure(rows, cols, N, block=b, perm=perm)
    ts = tb.BandStructure(rows, cols, N, block=b, perm=perm)
    idx = js.map(rows, cols)
    jband = jnp.stack([js.assemble(jnp.asarray(idx), jnp.asarray(v),
                                   jnp.float64) for _, _, v in lanes])
    asm = ts.assembly(ts.map(rows, cols), "cpu")
    tband = asm(torch.as_tensor(np.stack([v for _, _, v in lanes])))
    return js, jband, ts, tband


def test_plain_batched_kernels_match_jax_batch_grid(band_batch):
    js, jband, ts, tband = band_batch
    B, nb = tband.shape[0], ts.nb
    np.testing.assert_array_equal(tband.numpy(), np.asarray(jband))
    jf = jax.vmap(lambda bd: jps.pallas_banded_factorize_stream(
        js, bd, interpret=True))(jband)
    tf = tb.banded_factorize_batched(ts, tband)
    rhs = np.random.default_rng(4).standard_normal((B, ts.N))
    jx = jax.vmap(lambda f, r: jps.pallas_banded_solve_stream(
        js, f, r, interpret=True))(jf, jnp.asarray(rhs))
    tx = tb.banded_solve_batched(ts, tf, torch.as_tensor(rhs))
    inertia = tb.banded_inertia(ts, tf)
    assert inertia.shape == (B, 3)
    for i in range(B):
        assert _rel(tf.band[i, :nb], np.asarray(jf.band[i])[:nb]) < KERNEL_RTOL
        assert _rel(tf.invL[i, :nb], np.asarray(jf.invL[i])[:nb]) < KERNEL_RTOL
        assert _rel(tf.d[i], np.asarray(jf.d[i])) < KERNEL_RTOL
        assert _rel(tx[i], np.asarray(jx[i])) < KERNEL_RTOL
        lane = jb.BandedFactor(jf.band[i], jf.invL[i], jf.d[i])
        assert tuple(inertia[i]) == tuple(int(v) for v in
                                          jb.banded_inertia(js, lane))
    assert inertia[1, 1] == 1 and inertia[0, 2] == 0 and inertia[2, 2] > 0


def test_inactive_lanes_are_untouched(band_batch):
    _, _, ts, tband = band_batch
    B = tband.shape[0]
    full = tb.banded_factorize_batched(ts, tband)
    band = tband.clone()
    invL = torch.full((B, ts.nbp, ts.b, ts.b), 7.0, dtype=torch.float64)
    d = torch.full((B, ts.nb * ts.b), 3.0, dtype=torch.float64)
    active = np.array([False, True, True])
    before = (tk.banded_factorize_batched_cuda.launches,
              tk.banded_solve_batched_cuda.launches)
    f = tk.factorize_batched(ts, band, invL, d, active)
    assert torch.equal(f.band[0], tband[0])
    assert (f.invL[0] == 7.0).all() and (f.d[0] == 3.0).all()
    for i in (1, 2):
        assert torch.equal(f.band[i], full.band[i])
        assert torch.equal(f.d[i], full.d[i])
    rhs = torch.as_tensor(np.random.default_rng(5).standard_normal((B, ts.N)))
    x = tk.solve_batched(ts, f, rhs, active)
    assert torch.equal(x[0], rhs[0])
    assert torch.equal(x[1:], tb.banded_solve_batched(ts, full, rhs)[1:])
    # a CPU tensor takes the plain versions: the kernels never launched
    assert (tk.banded_factorize_batched_cuda.launches,
            tk.banded_solve_batched_cuda.launches) == before
    with pytest.raises(ValueError):
        tk.banded_factorize_batched_cuda(band, invL, d, active, ts.nb, ts.b,
                                         ts.bw)


# -- solve_batch against the JAX package ---------------------------------------


def _opts(pkg, richardson):
    return dict(linear_solver=pkg.LinearSolver.BANDED,
                print_level=pkg.PrintLevel.ERROR,
                richardson=richardson(mu_scaled=True))


@pytest.fixture(scope="module")
def jax118():
    """The JAX package's solver for the parametric nb=118 ACOPF (float64),
    its single solve of each scale and its initial state of each scale."""
    solver = J.MadNLPSolver(jopf.build_sparse(nb=118, seed=0, parametric=True),
                            **_opts(J, JRichardson))
    init = [solver._init_fn(jnp.asarray(sc)) for sc in SCALES]
    stats = []
    for sc in SCALES:
        solver.state = None          # a fresh solve, not a warm start
        stats.append(solver.solve(params=jnp.asarray(sc)))
    return stats, init


@pytest.fixture(scope="module")
def torch118():
    solver = T.MadNLPSolver(topf.build_sparse(nb=118, seed=0, parametric=True),
                            device="cpu", **_opts(T, T.RichardsonOptions))
    st = solver.solve_batch(SCALES)
    return solver, st, T.batch_summary(solver.prob, st)


def test_solve_batch_matches_jax_single_solves(jax118, torch118):
    jstats, _ = jax118
    _, st, summ = torch118
    assert [s.iter for s in jstats] == [30, 36, 34]
    assert [s.counters["factorization_cnt"] for s in jstats] == [38, 43, 40]
    c = summ["counters"]
    for i, js in enumerate(jstats):
        assert T.Status(int(summ["status"][i])).name == js.status.name \
            == "SOLVE_SUCCEEDED"
        assert summ["iter"][i] == js.iter
        assert c["factorization_cnt"][i] == js.counters["factorization_cnt"]
        assert abs(c["backsolve_cnt"][i] - js.counters["backsolve_cnt"]) <= 1
        assert abs(summ["objective"][i] - js.objective) \
            <= OBJ_RTOL * abs(js.objective)
        np.testing.assert_allclose(summ["x"][i], np.asarray(js.solution),
                                   rtol=0, atol=X_TOL)
    np.testing.assert_array_equal(st.theta.numpy(), SCALES)


def test_scale_one_lane_equals_the_nonparametric_solve(torch118):
    _, _, summ = torch118
    single = T.madnlp(topf.build_sparse(nb=118, seed=0), device="cpu",
                      **_opts(T, T.RichardsonOptions))
    i = SCALES.index(1.0)
    assert summ["iter"][i] == single.iter
    for c in ("factorization_cnt", "backsolve_cnt"):
        assert summ["counters"][c][i] == single.counters[c]
    assert abs(summ["objective"][i] - single.objective) \
        <= OBJ_RTOL * abs(single.objective)
    np.testing.assert_allclose(summ["x"][i], single.solution, rtol=0,
                               atol=X_TOL)


def _jax_state_arrays(st):
    """The leaves of a JAX ``State`` as numpy, under the keys
    ``state_from_arrays`` reads."""
    out = {}
    for name, v in zip(st._fields, st):
        if name in ("d", "p"):
            for part, a in zip(v._fields, v):
                out[f"{name}.{part}"] = np.asarray(a)
        elif name == "filter":
            out["filter.th"], out["filter.ph"], out["filter.count"] = (
                np.asarray(a) for a in v)
        elif name == "scal":
            out["scal.obj_scale"] = np.asarray(v.obj_scale)
            out["scal.con_scale"] = np.asarray(v.con_scale)
        elif isinstance(v, (jax.Array, np.ndarray)):
            out[name] = np.asarray(v)
    return out


def test_batched_initialize_matches_jax(jax118, torch118):
    _, init = jax118
    solver, _, _ = torch118
    lanes = [_jax_state_arrays(s) for s in init]
    jst = batch_state_from_arrays(
        {k: np.stack([a[k] for a in lanes]) for k in lanes[0]}, "cpu")
    tst = solver.batch_kernel.initialize(
        torch.tensor(SCALES, dtype=torch.float64))
    for f in ("x", "y", "zl", "zu", "xl", "xu", "c", "f"):
        for i in range(len(SCALES)):
            assert _rel(getattr(tst, f)[i], getattr(jst, f)[i]) < 1e-9, f
    np.testing.assert_allclose(tst.scal.obj_scale.numpy(),
                               jst.scal.obj_scale.numpy(), rtol=1e-14)
    np.testing.assert_allclose(tst.scal.con_scale.numpy(),
                               jst.scal.con_scale.numpy(), rtol=1e-14)
    for f in ("mu", "tau", "theta_max", "theta_min", "obj_val"):
        np.testing.assert_allclose(getattr(tst, f), getattr(jst, f),
                                   rtol=1e-12, err_msg=f)
    np.testing.assert_array_equal(tst.status, jst.status)
    np.testing.assert_array_equal(tst.theta.numpy(), jst.theta.numpy())
    np.testing.assert_array_equal(tst.filter.count, jst.filter.count)
    # the lanes' scalings differ: one scale per scenario, not one shared
    assert len(set(tst.theta_max.tolist())) == len(SCALES)


# -- chunking, the parametric single solve, errors -----------------------------


def _solver48():
    return T.MadNLPSolver(topf.build_sparse(nb=48, seed=0, parametric=True),
                          device="cpu", **_opts(T, T.RichardsonOptions))


def test_chunked_matches_bulk():
    scales = np.array([1.05, 1.0, 0.95, 0.9])      # reversed: the probe sorts
    solver = _solver48()
    bulk = T.batch_summary(solver.prob, solver.solve_batch(scales))
    st = solver.solve_batch(scales, chunk_size=2, probe_iters=3)
    chunked = T.batch_summary(solver.prob, st)
    np.testing.assert_array_equal(st.theta.numpy(), scales)
    np.testing.assert_array_equal(chunked["status"], bulk["status"])
    assert (chunked["status"] == int(T.Status.SOLVE_SUCCEEDED)).all()
    np.testing.assert_array_equal(chunked["iter"], bulk["iter"])
    np.testing.assert_array_equal(chunked["counters"]["factorization_cnt"],
                                  bulk["counters"]["factorization_cnt"])
    np.testing.assert_allclose(chunked["objective"], bulk["objective"],
                               rtol=OBJ_RTOL)
    np.testing.assert_allclose(chunked["x"], bulk["x"], rtol=0, atol=X_TOL)
    # a load scale's objective grows with the load: the lanes came back in
    # the caller's order
    assert (np.diff(bulk["objective"]) < 0).all()


def test_parametric_single_solve_at_scale_one_is_the_plain_solve():
    opts = dict(device="cpu", **_opts(T, T.RichardsonOptions))
    plain = T.madnlp(topf.build_sparse(nb=40, seed=2), **opts)
    param = T.madnlp(topf.build_sparse(nb=40, seed=2, parametric=True),
                     params=1.0, **opts)
    assert param.iter == plain.iter and param.counters == plain.counters
    assert param.objective == plain.objective
    assert np.array_equal(param.solution, plain.solution)


def test_batch_options_that_raise():
    solver = _solver48()
    with pytest.raises(NotImplementedError, match="later slice"):
        solver.solve_batch([1.0, 1.1], sharding=object())
    with pytest.raises(ValueError, match="chunk_size"):
        solver.solve_batch([1.0, 1.1, 1.2, 1.3], chunk_size=3)


# -- the shared IPM kernels over a lane axis ----------------------------------


def _lane_vectors(B=3, n=40):
    """Seeded (B, n) iterates with some bounds switched off."""
    rng = np.random.default_rng(7)

    def t(a):
        return torch.as_tensor(a)

    x = t(rng.standard_normal((B, n)))
    xl, xu = x - t(rng.uniform(0.1, 1.0, (B, n))), x + t(rng.uniform(0.1, 1.0, (B, n)))
    lb, ub = t(rng.random(n) < 0.7), t(rng.random(n) < 0.6)
    zl = torch.where(lb, t(rng.uniform(0.1, 2.0, (B, n))), 0.0)
    zu = torch.where(ub, t(rng.uniform(0.1, 2.0, (B, n))), 0.0)
    dx = t(rng.standard_normal((B, n)))
    f, c = t(rng.standard_normal((B, n))), t(rng.standard_normal((B, 9)))
    return x, xl, xu, lb, ub, zl, zu, dx, f, c


@pytest.mark.parametrize("name", ["varphi", "varphi_d", "inf_compl",
                                  "alpha_max", "alpha_z", "theta", "sd",
                                  "adjust", "reset_dual"])
def test_ipm_kernels_broadcast_over_lanes(name):
    """Each lane of a batched kernel call equals the single call with that
    lane's per-lane scalars (μ, τ, the objective) as host floats."""
    from madnlp_tpu_torch.ipm import kernels as K

    x, xl, xu, lb, ub, zl, zu, dx, f, c = _lane_vectors()
    mu = torch.tensor([0.1, 1e-3, 2.5], dtype=torch.float64)
    tau = torch.tensor([0.99, 0.995, 0.9], dtype=torch.float64)
    obj = torch.tensor([1.5, -2.0, 0.25], dtype=torch.float64)
    dl, du = K.slacks(x, xl, xu, lb, ub)
    calls = {
        "varphi": lambda i: K.get_varphi(
            obj if i is None else float(obj[i]), *_at((dl, du), i), lb, ub,
            mu if i is None else float(mu[i])),
        "varphi_d": lambda i: K.get_varphi_d(
            *_at((f, dl, du), i), lb, ub, *_at((dx,), i),
            mu if i is None else float(mu[i])),
        "inf_compl": lambda i: K.get_inf_compl(
            *_at((dl, du, zl, zu), i), lb, ub,
            mu if i is None else float(mu[i]), 1.0),
        "alpha_max": lambda i: K.get_alpha_max(
            *_at((x, xl, xu, dx), i), tau if i is None else float(tau[i]),
            lb, ub),
        "alpha_z": lambda i: K.get_alpha_z(
            *_at((zl, zu, dx, -dx), i), tau if i is None else float(tau[i]),
            lb, ub),
        "theta": lambda i: K.get_theta(*_at((c,), i)),
        "sd": lambda i: K.get_sd(*_at((c, zl, zu), i), lb, ub, 9,
                                 int(lb.sum()), int(ub.sum()), 100.0),
        "adjust": lambda i: torch.stack(K.adjust_boundary(
            *_at((x, xl, xu), i), lb, ub, mu if i is None else float(mu[i]))),
        "reset_dual": lambda i: K.reset_bound_dual(
            *_at((zl, dl), i), lb, mu if i is None else float(mu[i]), 1e10),
    }
    batched = calls[name](None)
    for i in range(x.shape[0]):
        lane = batched[:, i] if name == "adjust" else batched[i]
        torch.testing.assert_close(lane, calls[name](i), rtol=1e-14, atol=0)


def _at(vectors, i):
    return vectors if i is None else tuple(v[i] for v in vectors)


def test_filter_ops_per_lane():
    """A batch's filter, updated lane by lane under masks, holds each lane's
    single-solve filter."""
    from madnlp_tpu_torch.ipm import kernels as K

    every = np.ones(3, dtype=bool)
    batch = K.filter_stack([K.filter_init(5)] * 3)
    batch = K.filter_lanes(K.filter_reset, batch, every,
                           np.array([10., 20., 30.]))

    def augment(f, th, ph):
        return K.filter_augment(f, th, ph, 1e-5)

    batch = K.filter_lanes(augment, batch, every, np.array([1., 2., 3.]),
                           np.array([-1., 0., 1.]))
    batch = K.filter_lanes(augment, batch, np.array([True, False, True]),
                           np.full(3, .5), np.zeros(3))
    for i, (tm, th, ph, more) in enumerate(((10., 1., -1., True),
                                            (20., 2., 0., False),
                                            (30., 3., 1., True))):
        single = augment(K.filter_reset(K.filter_init(5), tm), th, ph)
        if more:
            single = augment(single, .5, 0.)
        lane = K.filter_lane(batch, i)
        np.testing.assert_array_equal(lane.th, single.th)
        np.testing.assert_array_equal(lane.ph, single.ph)
        assert lane.count == single.count
        for theta, varphi in ((0.4, 5.0), (2.5, -3.0), (40.0, -1e9)):
            assert (K.is_filter_acceptable(lane, theta, varphi)
                    == K.is_filter_acceptable(single, theta, varphi))
