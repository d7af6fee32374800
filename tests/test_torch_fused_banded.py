"""The plain versions of K5 and K6 (madnlp_tpu_torch/ops/
banded_fused_kernels.py) against the JAX package's whole-band Pallas
kernels run in interpret mode (madnlp_tpu/ops/pallas_banded.py:
``pallas_banded_factorize`` / ``pallas_banded_solve``, ``interpret=True``),
on the same numpy-seeded band systems.

The plain versions are the port's plain banded factor and solve, which
follow the TPU kernel's panel-blocked order; these tests show that they
compute what the TPU kernels compute.  Tolerances are normwise relative,
``max|port − ref| / max|ref|`` over the real block columns (the overhang
is don't-care in the reference): 1e-12 in float64, 1e-5 in float32, on
strictly diagonally dominant indefinite bands and on one with an exactly
zero pivot; inertia exact, the zero pivot counted.  Right-hand sides of
k = 1, 3, 8 and 130 columns cover both of the TPU kernel's width paddings
(8·⌈k/8⌉ below 128, 128·⌈k/128⌉ from 128 up).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madnlp_tpu.ops import banded as jb
from madnlp_tpu.ops import pallas_banded as jpb
from madnlp_tpu_torch.ops import banded as tb
from madnlp_tpu_torch.ops import banded_fused_kernels as fk
from madnlp_tpu_torch.testing import band_system

torch.set_num_threads(1)

# (N, b, bw): two seeded geometries (nb = 3 and 5) and a bw=1
# band with a padded tail block
GEOMETRIES = [(96, 32, 3), (300, 64, 5), (90, 32, 1)]
RTOL = {"float64": 1e-12, "float32": 1e-5}
TDT = {"float64": torch.float64, "float32": torch.float32}
WIDTHS = (1, 3, 8, 130)


def _rel(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300)


def _pair(N, b, bw, dtype, zero_row):
    """One seeded band assembled by both packages (identity ordering)."""
    rows, cols, vals = band_system(N + b + bw, N, b, bw, zero_row=zero_row,
                                   density=0.3)
    perm = np.arange(N)
    js = jb.BandStructure(rows, cols, N, block=b, perm=perm)
    ts = tb.BandStructure(rows, cols, N, block=b, perm=perm)
    assert (ts.b, ts.bw, ts.nb) == (js.b, js.bw, js.nb) == (b, bw, -(-N // b))
    jband = js.assemble(jnp.asarray(js.map(rows, cols)), jnp.asarray(vals),
                        jnp.dtype(dtype))
    tband = ts.assembly(ts.map(rows, cols), "cpu")(
        torch.as_tensor(vals)).to(TDT[dtype])
    return js, jband, ts, tband


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("N,b,bw", GEOMETRIES)
def test_plain_k5_k6_match_pallas_interpret(N, b, bw, zero, dtype):
    zero_row = N // 2 if zero else None
    js, jband, ts, tband = _pair(N, b, bw, dtype, zero_row)
    nb, rtol = ts.nb, RTOL[dtype]
    jf = jax.jit(functools.partial(jpb.pallas_banded_factorize, js,
                                   interpret=True))(jband)
    tf = fk.banded_fused_factorize(ts, tband)
    assert _rel(tf.band[:nb].numpy(), np.asarray(jf.band)[:nb]) < rtol
    assert _rel(tf.invL[:nb].numpy(), np.asarray(jf.invL)[:nb]) < rtol
    assert _rel(tf.d.numpy(), np.asarray(jf.d)) < rtol
    inertia = tb.banded_inertia(ts, tf)
    assert inertia == tuple(int(v) for v in jb.banded_inertia(js, jf))
    assert inertia[1] == (1 if zero else 0)

    solve = jax.jit(functools.partial(jpb.pallas_banded_solve, js,
                                      interpret=True))
    rng = np.random.default_rng(N + bw)
    for k in WIDTHS:
        rhs = rng.standard_normal(N if k == 1 else (N, k))
        jx = np.asarray(solve(jf, jnp.asarray(rhs, jnp.dtype(dtype))))
        tx = fk.banded_fused_solve(ts, tf, torch.as_tensor(rhs).to(TDT[dtype]))
        assert tx.shape == rhs.shape
        assert _rel(tx.numpy(), jx) < rtol, k


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor routes to the plain versions: the input band is left as
    it was, the result equals the plain functions' bit for bit, and no
    kernel is counted."""
    _, _, ts, tband = _pair(96, 32, 3, "float64", None)
    fk.reset_counts()
    before = tband.clone()
    f = fk.banded_fused_factorize(ts, tband)
    assert torch.equal(tband, before)
    ref = tb.banded_factorize(ts, tband)
    assert all(torch.equal(a, r) for a, r in zip(f, ref))
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal((96, 3)))
    x = fk.banded_fused_solve(ts, f, rhs)
    assert torch.equal(x, fk.banded_fused_solve_plain(ts, f, rhs))
    assert _rel(x.numpy(), tb.banded_solve(ts, ref, rhs).numpy()) < 1e-14
    assert fk.counts() == {"banded_fused_factorize_cuda": 0,
                           "banded_fused_solve_cuda": 0}
    assert [fk.pad_width(k) for k in (1, 8, 9, 127, 128, 130)] == \
        [8, 8, 16, 128, 128, 256]


def test_wrappers_refuse_cpu_tensors():
    """The kernels themselves take only CUDA tensors: there is no silent
    fallback below the public functions."""
    _, _, ts, tband = _pair(96, 32, 3, "float64", None)
    invL = tband.new_zeros((ts.nbp, 32, 32))
    d = tband.new_ones((ts.nbp * 32,))
    with pytest.raises(ValueError, match="CUDA"):
        fk.banded_fused_factorize_cuda(tband, invL, d, ts.nb, 32, ts.bw)
    with pytest.raises(ValueError, match="CUDA"):
        fk.banded_fused_solve_cuda(tband, invL, d,
                                   tband.new_zeros((ts.nbp * 32, 8)))
