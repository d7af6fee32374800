"""Parity of the port's plain block-banded LDLᵀ (madnlp_tpu_torch/ops/banded.py)
with the JAX package: the XLA band loop (ops/banded.py) and the streaming
Pallas kernels run in interpret mode (ops/pallas_banded_stream.py), on the
same numpy-seeded band systems.

The port's plain factorization follows the Pallas kernel's panel-blocked
algorithm, the XLA loop an unblocked one: they agree to rounding.
Tolerances are normwise, ``max|port − ref| / max|ref|``: 1e-10 in float64,
1e-4 in float32 (the systems are strictly diagonally dominant, so growth is
bounded and f32 reordering noise stays near 1e-6).  Only the real block
columns are compared: the overhang columns are never factored and the
Pallas kernel writes don't-care values there.  Inertia must agree exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madnlp_tpu.ops import banded as jb
from madnlp_tpu.ops import pallas_banded_stream as jps
from madnlp_tpu_torch.ops import banded as tb
from madnlp_tpu_torch.ops import banded_kernels as tk
from madnlp_tpu_torch.testing import band_system

torch.set_num_threads(1)

# (N, b, bw, dtype): bw ∈ {1, 2, 3} at b ∈ {32, 64} in float64, and one
# of each bw in float32
CASES = [(90, 32, 1, "float64"), (150, 32, 2, "float64"),
         (200, 32, 3, "float64"), (180, 64, 1, "float64"),
         (300, 64, 2, "float64"), (420, 64, 3, "float64"),
         (90, 32, 1, "float32"), (300, 64, 2, "float32"),
         (200, 32, 3, "float32")]
RTOL = {"float64": 1e-10, "float32": 1e-4}
TDT = {"float64": torch.float64, "float32": torch.float32}


def _jit(fn, struct, **kw):
    """One compiled program for a JAX reference function on ``struct``
    (evaluated op by op, each primitive compiles on its own)."""
    return jax.jit(functools.partial(fn, struct, **kw))


def _system(seed, N, b, bw, signs=False, zero_row=None):
    """Strictly diagonally dominant band matrix (lower COO, identity
    ordering) with scalar bandwidth bw·b − 1; ``signs`` makes it indefinite,
    ``zero_row`` gives an exactly zero pivot."""
    return band_system(seed, N, b, bw, signs=signs, zero_row=zero_row,
                       density=0.3)


def _pair(rows, cols, vals, N, b, dtype):
    """The same band assembled by both packages."""
    perm = np.arange(N)
    js = jb.BandStructure(rows, cols, N, block=b, perm=perm)
    ts = tb.BandStructure(rows, cols, N, block=b, perm=perm)
    jband = js.assemble(jnp.asarray(js.map(rows, cols)), jnp.asarray(vals),
                        jnp.dtype(dtype))
    tband = ts.assembly(ts.map(rows, cols), "cpu")(
        torch.as_tensor(vals)).to(TDT[dtype])
    return js, jband, ts, tband


def _rel(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _check_factor(tf, jf, nb, rtol):
    assert _rel(tf.band[:nb].numpy(), np.asarray(jf.band)[:nb]) < rtol
    assert _rel(tf.invL[:nb].numpy(), np.asarray(jf.invL)[:nb]) < rtol
    assert _rel(tf.d.numpy(), np.asarray(jf.d)) < rtol


def test_assembly_matches_and_repeats():
    rows, cols, vals = _system(0, 150, 32, 2)
    # duplicate coordinates must sum
    rows = np.concatenate([rows, rows[:40]])
    cols = np.concatenate([cols, cols[:40]])
    vals = np.concatenate([vals, np.linspace(-1, 1, 40)])
    js, jband, ts, tband = _pair(rows, cols, vals, 150, 32, "float64")
    np.testing.assert_allclose(tband.numpy(), np.asarray(jband),
                               rtol=1e-15, atol=1e-15)
    again = ts.assembly(ts.map(rows, cols), "cpu")(torch.as_tensor(vals))
    assert torch.equal(again, tband)
    assert (ts.perm == js.perm).all() and ts.bw == js.bw and ts.nb == js.nb


@pytest.mark.parametrize("N,b,bw,dtype", CASES)
def test_factorize_solve_match_xla(N, b, bw, dtype):
    rows, cols, vals = _system(N + b + bw, N, b, bw, signs=True)
    js, jband, ts, tband = _pair(rows, cols, vals, N, b, dtype)
    assert ts.bw == bw
    jf = _jit(jb.banded_factorize, js)(jband)
    tf = tb.banded_factorize(ts, tband)
    _check_factor(tf, jf, ts.nb, RTOL[dtype])
    assert tb.banded_inertia(ts, tf) == tuple(int(v) for v in
                                              jb.banded_inertia(js, jf))
    rhs = np.random.default_rng(N).standard_normal((N, 2))
    jx = _jit(jb.banded_solve, js)(jf, jnp.asarray(rhs, jnp.dtype(dtype)))
    tx = tb.banded_solve(ts, tf, torch.as_tensor(rhs).to(TDT[dtype]))
    assert _rel(tx.numpy(), np.asarray(jx)) < RTOL[dtype]
    tx1 = tb.banded_solve(ts, tf, torch.as_tensor(rhs[:, 0]).to(TDT[dtype]))
    assert tx1.shape == (N,)
    assert _rel(tx1.numpy(), np.asarray(jx)[:, 0]) < RTOL[dtype]


@pytest.mark.parametrize("N,b,bw,dtype", [(150, 32, 2, "float64"),
                                          (200, 32, 3, "float32"),
                                          (200, 32, 4, "float64")])
def test_factorize_solve_match_pallas_interpret(N, b, bw, dtype):
    rows, cols, vals = _system(7 * N + bw, N, b, bw, signs=True)
    js, jband, ts, tband = _pair(rows, cols, vals, N, b, dtype)
    jf = _jit(jps.pallas_banded_factorize_stream, js, interpret=True)(jband)
    tf = tb.banded_factorize(ts, tband)
    _check_factor(tf, jf, ts.nb, RTOL[dtype])
    rhs = np.random.default_rng(3).standard_normal(N)
    jx = _jit(jps.pallas_banded_solve_stream, js, interpret=True)(
        jf, jnp.asarray(rhs, jnp.dtype(dtype)))
    tx = tb.banded_solve(ts, tf, torch.as_tensor(rhs).to(TDT[dtype]))
    assert _rel(tx.numpy(), np.asarray(jx)) < RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_zero_pivot_divides_as_inf(dtype):
    N, b, bw = 150, 32, 2
    rows, cols, vals = _system(11, N, b, bw, zero_row=70)
    js, jband, ts, tband = _pair(rows, cols, vals, N, b, dtype)
    jf = _jit(jb.banded_factorize, js)(jband)
    tf = tb.banded_factorize(ts, tband)
    assert float(tf.d[70]) == 0.0 and float(jf.d[70]) == 0.0
    _check_factor(tf, jf, ts.nb, RTOL[dtype])
    inertia = tb.banded_inertia(ts, tf)
    assert inertia == tuple(int(v) for v in jb.banded_inertia(js, jf))
    assert inertia == (N - 1, 1, 0)


def test_ruiz_scale_symv_match():
    N, b, bw = 150, 32, 2
    rows, cols, vals = _system(5, N, b, bw, signs=True)
    vals = vals * np.exp(np.random.default_rng(6).uniform(-6, 6, len(vals)))
    js, jband, ts, tband = _pair(rows, cols, vals, N, b, "float64")
    jsym = _jit(jb.banded_symmetrize, js)(jband)
    tsym = tb.banded_symmetrize(ts, tband)
    np.testing.assert_array_equal(tsym.numpy(), np.asarray(jsym))
    jd = _jit(jb.ruiz_band, js)(jsym)
    td = tb.ruiz_band(ts, tsym)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-13)
    np.testing.assert_allclose(tb.scale_band(ts, tband, td).numpy(),
                               np.asarray(_jit(jb.scale_band, js)(jband, jd)),
                               rtol=1e-12, atol=0)
    x = np.random.default_rng(8).standard_normal(N)
    np.testing.assert_allclose(
        tb.banded_symv(ts, tsym, torch.as_tensor(x)).numpy(),
        np.asarray(_jit(jb.banded_symv, js)(jsym, jnp.asarray(x))),
        rtol=1e-12, atol=1e-12 * np.abs(vals).max())


def test_ruiz_keeps_zero_rows_at_one():
    N, b, bw = 150, 32, 2
    rows, cols, vals = _system(9, N, b, bw, zero_row=40)
    _, _, ts, tband = _pair(rows, cols, vals, N, b, "float64")
    d = tb.ruiz_band(ts, tb.banded_symmetrize(ts, tband)).reshape(-1)
    assert float(d[40]) == 1.0
    assert (d[N:] == 1.0).all()          # padding and overhang rows


def test_ordering_matches_jax():
    from madnlp_tpu.models.instances import opf as jopf
    from madnlp_tpu.native import jtdj_pair_map as j_pairs

    model = jopf.build_sparse(nb=40, seed=2)
    m, n = model.m, model.n
    for a, c in zip(tb.jtdj_pair_map(model.jac_rows, model.jac_cols, m),
                    j_pairs(model.jac_rows, model.jac_cols, m)):
        assert sorted(zip(a.tolist())) == sorted(zip(c.tolist()))
    args = (model.hess_rows, model.hess_cols, model.jac_rows, model.jac_cols,
            n, m)
    np.testing.assert_array_equal(tb.kkt_interleaved_ordering(*args),
                                  jb.kkt_interleaved_ordering(*args))


def test_cpu_tensors_take_the_plain_path():
    """CPU tensors run the plain versions, single and batched, with no
    launch of any kernel (the cluster solve K2 / K4 and its witness
    included); the CUDA wrappers refuse CPU tensors."""
    rows, cols, vals = _system(2, 90, 32, 1)
    _, _, ts, tband = _pair(rows, cols, vals, 90, 32, "float64")
    before = tk.counts()
    f = tk.factorize(ts, tband)
    ref = tb.banded_factorize(ts, tband)
    assert torch.equal(f.band, ref.band) and torch.equal(f.d, ref.d)
    rhs = torch.ones(90, dtype=torch.float64)
    assert torch.equal(tk.solve(ts, f, rhs), tb.banded_solve(ts, ref, rhs))
    bands = torch.stack([tband, 2 * tband])
    active = np.array([True, False])
    fb = tk.factorize_batched(ts, bands.clone(), bands.new_zeros(
        (2, ts.nbp, 32, 32)), bands.new_ones((2, ts.nb * 32)), active)
    assert torch.equal(fb.band[0], ref.band) and torch.equal(fb.band[1],
                                                             bands[1])
    rb = torch.stack([rhs, -rhs])
    xb = tk.solve_batched(ts, fb, rb, active)
    assert torch.equal(xb[0], tb.banded_solve(ts, ref, rhs))
    assert torch.equal(xb[1], rb[1])
    assert tk.counts() == before
    with pytest.raises(ValueError):
        tk.banded_factorize_cuda(tband, ref.invL, ref.d, ts.nb, 32, 1)
    with pytest.raises(ValueError):
        tk.banded_solve_cuda(ref.band, ref.invL, ref.d, rhs[:, None])
    with pytest.raises(ValueError):
        tk.banded_solve_reference_cuda(ref.band, ref.invL, ref.d,
                                       rhs[:, None])


@pytest.mark.parametrize("b,dtype", [(32, "float64"), (64, "float64"),
                                     (64, "float32")])
def test_block_ldlt_matches_pallas_ldlt_with_inverse(b, dtype):
    """The plain diagonal step (``ldlt_with_inverse``: the panel-blocked
    LDLᵀ and L⁻¹ of one lower-stored block, the reference of K1/K3/K5's
    tiled step and of the scalar one K5's witness keeps) against the TPU kernel's
    ``pallas_banded._ldlt_with_inverse``, on a dominant indefinite block and
    on one with an exactly zero pivot."""
    from madnlp_tpu.ops.pallas_banded import _ldlt_with_inverse

    for seed, zero in ((b, None), (b + 1, b // 2)):
        rows, cols, vals = _system(seed, b, b, 1, signs=True, zero_row=zero)
        A = np.zeros((b, b))
        A[rows, cols] = vals
        LD, invL = tb.ldlt_with_inverse(torch.as_tensor(A).to(TDT[dtype]))
        jLD, jinvL = _ldlt_with_inverse(jnp.asarray(A, dtype=dtype), b)
        assert _rel(LD.numpy(), np.tril(np.asarray(jLD))) < RTOL[dtype]
        assert _rel(invL.numpy(), np.asarray(jinvL)) < RTOL[dtype]
        assert int((torch.diagonal(LD) == 0).sum()) == (0 if zero is None
                                                       else 1)


# -- the plain recursions' host path ------------------------------------------


def _recursions():
    from madnlp_tpu_torch.ops import dense_kernels, ldlt

    return {
        "corner": (tb, tb._corner_ldlt),
        "unblocked": (ldlt, ldlt.ldlt_unblocked),
        "unit_lower_inverse": (dense_kernels, lambda A: (
            dense_kernels._unit_lower_inverse(
                torch.tril(A, -1) + torch.eye(A.shape[0], dtype=A.dtype)),)),
    }


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["corner", "unblocked", "unit_lower_inverse"])
def test_host_recursions_are_the_torch_steps_bit_for_bit(name, dtype,
                                                         monkeypatch):
    """On a CPU tensor the scalar recursions of the plain factorizations
    (the corner of K1/K3's diagonal step, the dense LDLᵀ's diagonal block
    and its unit-lower inverse) run through numpy views of the tensor's
    memory; with the views switched off they run the torch steps that
    every other device runs.  Both give the same bits, zero and denormal
    pivots and NaN included."""
    module, fn = _recursions()[name]
    rng = np.random.default_rng(8)
    for p, mark in ((32, None), (32, "zero"), (64, "tiny"), (5, "nan")):
        A = rng.standard_normal((p, p)) * 10.0 ** rng.integers(-4, 4)
        A = A + A.T
        if mark == "zero":
            A[3, :] = A[:, 3] = 0.0
        elif mark == "tiny":
            A[1, 1] = 1e-31
        elif mark == "nan":
            A[2, 2] = np.nan
        A = torch.tensor(A, dtype=TDT[dtype])
        host = fn(A.clone())
        with monkeypatch.context() as m:
            m.setattr(module, "host_view", lambda t: t)
            steps = fn(A.clone())
        host = host if isinstance(host, tuple) else (host,)
        steps = steps if isinstance(steps, tuple) else (steps,)
        for u, v in zip(host, steps):
            assert u.dtype == v.dtype == A.dtype
            assert np.array_equal(u.numpy().view(np.uint8),
                                  v.numpy().view(np.uint8))
