"""The dense path's LDLᵀ goes through the K7 wrapper
(``ops/dense_kernels.py:dense_ldlt``): on a CPU tensor it is the plain
version, bit for bit, in both solve modes; a dense solve calls it once per
factorization; the card's block limit is checked before anything else.
Pure torch on the CPU: no JAX reference is needed, the plain version's
parity with the JAX package is held in tests/test_torch_dense.py.
"""

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models.instances import opf
from madnlp_tpu_torch.ops import dense_kernels as dk
from madnlp_tpu_torch.ops import dense_solvers as ds
from madnlp_tpu_torch.utils.options import LinearSolver

torch.set_num_threads(1)


def _saddle(N, seed, dtype, zero_row=None):
    """A seeded saddle matrix [[H, Jᵀ], [J, -1e-3·I]] (H SPD, N/4 rows of
    J); ``zero_row`` zeroes a row and column (a zero pivot)."""
    rng = np.random.default_rng(seed)
    m = N // 4
    R = rng.standard_normal((N - m, N - m))
    J = rng.standard_normal((m, N - m))
    K = np.block([[R @ R.T + N * np.eye(N - m), J.T], [J, -1e-3 * np.eye(m)]])
    if zero_row is not None:
        K[zero_row, :] = 0.0
        K[:, zero_row] = 0.0
    return torch.as_tensor(K, dtype=dtype)


def _same_bits(a, b):
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


@pytest.mark.parametrize("mode", ["trisolve", "inverse"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,block,zero_row", [(130, 64, None), (97, 32, 40),
                                              (60, 128, 7), (45, 12, None)])
def test_factorize_ldl_is_the_plain_kernel_version(N, block, zero_row, dtype,
                                                   mode):
    K = _saddle(N, N + block, dtype, zero_row)
    f = ds.factorize(K, LinearSolver.LDL, block=block, solve_mode=mode)
    ref = dk.dense_ldlt_plain(K, block)
    assert f.n == ref.n == N
    assert _same_bits(f.b, ref.d)
    L = ref.L if mode == "trisolve" else ds._tri_inverse(ref.L, unit=True)
    assert _same_bits(f.a, L)
    m = N // 4
    expect = (N - m, 0, m) if zero_row is None else (N - m - 1, 1, m)
    assert ds.inertia(f) == expect
    # and it solves
    rhs = torch.as_tensor(np.random.default_rng(N).standard_normal(N),
                          dtype=dtype)
    if zero_row is None:
        x = ds.solve(f, rhs)
        tol = 1e-4 if dtype == torch.float32 else 1e-10
        assert float((K @ x - rhs).abs().max()) < tol * float(rhs.abs().max()
                                                               * N)


@pytest.mark.parametrize("mode", ["trisolve", "inverse"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_solve_calls_the_wrapper_once_per_factorization(dtype, mode,
                                                              monkeypatch):
    """Every factorization of a dense LDL solve, and the uncounted one of
    the least-squares dual initialization, goes through ``dense_ldlt``; on
    the CPU no kernel launches."""
    calls = []
    plain = dk.dense_ldlt

    def counting(A, block=128):
        calls.append(block)
        return plain(A, block)

    monkeypatch.setattr(dk, "dense_ldlt", counting)
    dk.reset_counts()
    s = T.madnlp(opf.build(nb=30, seed=1), device="cpu", dtype=dtype,
                 solve_mode=mode, print_level=T.PrintLevel.ERROR)
    assert s.status == T.Status.SOLVE_SUCCEEDED
    assert len(calls) == s.counters["factorization_cnt"] + 1
    assert set(calls) == {64}      # nw + m < 1024: the 64-wide preset
    assert not any(dk.counts().values())


@pytest.mark.parametrize("block", [0, 129, 256, -1])
def test_card_block_limit_is_checked_first(block):
    """Above 128 (or below 1) the card path raises ValueError naming the
    limit, before it looks at the tensor; the CPU path takes any block."""
    dk.reset_counts()
    K = _saddle(256, 3, torch.float64)
    with pytest.raises(ValueError, match=r"1\.\.128"):
        dk.dense_ldlt_cuda(K, block)
    with pytest.raises(ValueError, match=r"1\.\.128"):
        dk.check_block(block)
    if block > 0:
        f = dk.dense_ldlt(K, block)
        ref = dk.dense_ldlt_plain(K, block)
        assert _same_bits(f.L, ref.L) and _same_bits(f.d, ref.d)
    assert not any(dk.counts().values())


def test_wrappers_refuse_cpu_tensors():
    dk.reset_counts()
    K = _saddle(128, 4, torch.float32)
    for block in (1, 48, 128):
        dk.check_block(block)
        with pytest.raises(ValueError, match="CUDA"):
            dk.dense_ldlt_cuda(K.clone(), block)
    with pytest.raises(ValueError, match="CUDA"):
        dk.dense_ldlt_reference_cuda(K.clone(), 128)
    with pytest.raises(ValueError):
        dk.dense_ldlt_reference_cuda(K.clone(), 48)
    assert dk.counts() == {"dense_ldlt_cuda": 0,
                           "dense_ldlt_reference_cuda": 0}
