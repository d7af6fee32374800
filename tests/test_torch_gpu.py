"""The Hopper kernels of the port against their plain PyTorch versions, on
the card: K1/K2 (one system) and K3/K4 (a batch of lanes under an active
mask, also held against K1/K2 on each lane) of csrc/banded_ldlt.cu, K5/K6
(the whole-band factorize in one launch over a thread-block cluster and
the solve over a cluster per column tile) of csrc/banded_fused.cu, held bit
for bit against their witnesses (the one-CTA kernels they replaced), and
K7, the whole-matrix dense LDLᵀ of
csrc/dense_ldlt.cu (held bit for bit against its first version, the witness,
and at blocks the witness does not take against the plain version); small
solves of the sparse, batched and dense paths
on the card against the CPU; and the case118 bench-configuration solve
on the card against the JAX package's numbers.  K1, K3 and K5 run the
tiled diagonal step, K5's witness the scalar one it was rewritten from:
their factors, and the two steps alone, are held equal bit for bit.  K2 and K4 run one
thread-block cluster per system; the one-CTA solve they replaced
(``banded_solve_reference_cuda``) is their witness, held equal bit for
bit.

Run on a machine with an NVIDIA GPU and nvcc (``--noconftest`` skips
tests/conftest.py, which imports JAX):

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest

Each test decides for itself whether a card is present and skips without
one.  Tolerances are normwise relative, kernel vs plain on strictly
diagonally dominant indefinite band matrices and on well-conditioned
saddle matrices, where only the order of summation differs: 1e-10 in
float64, 1e-4 in float32.  Inertia must agree exactly.
"""

import os

import numpy as np
import pytest
import torch

import madnlp_tpu_torch as T
from madnlp_tpu_torch.models import matpower
from madnlp_tpu_torch.models.instances import opf
from madnlp_tpu_torch.ops import banded as plain
from madnlp_tpu_torch.ops import banded_fused_kernels as bf
from madnlp_tpu_torch.ops import banded_kernels as bk
from madnlp_tpu_torch.ops import dense_kernels as dk
from madnlp_tpu_torch.ops.ldlt import ldlt_inertia
from madnlp_tpu_torch.testing import band_system

pytestmark = pytest.mark.gpu

RTOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _system(seed, nb, b, bw, dtype):
    """A seeded diagonally dominant indefinite band on the card, with
    N = nb·b − b/2 (a padded tail block)."""
    N = nb * b - b // 2
    rows, cols, vals = band_system(seed, N, b, bw)
    st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
    band = st.assembly(st.map(rows, cols), "cpu")(torch.as_tensor(vals))
    return st, band.to(dtype).cuda()


def _rel(a, ref):
    a, ref = a.double(), ref.double()
    return float((a - ref).abs().max() / ref.abs().max())


def _lanes(nb, b, bw, dtype, zero_lane=1, lanes=3):
    """A batch of seeded band systems of one geometry on the card; lane
    ``zero_lane`` carries an exactly zero pivot."""
    N = nb * b - b // 2
    bands = []
    for i in range(lanes):
        rows, cols, vals = band_system(10 * i + b + bw + nb, N, b, bw,
                                       zero_row=N // 2 if i == zero_lane
                                       else None)
        st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
        assert (st.b, st.bw, st.nb) == (b, bw, nb)
        bands.append(st.assembly(st.map(rows, cols), "cpu")(
            torch.as_tensor(vals)))
    return st, torch.stack(bands).to(dtype).cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", [(256, 2, 11), (128, 3, 5), (64, 1, 6),
                                     (32, 2, 9)])
def test_kernels_match_plain(b, bw, nb, dtype):
    _need_cuda()
    st, band = _system(b + bw + nb, nb, b, bw, dtype)
    assert (st.b, st.bw, st.nb) == (b, bw, nb)
    before = (bk.banded_factorize_cuda.launches, bk.banded_solve_cuda.launches)
    kf = bk.factorize(st, band.clone())
    pf = plain.banded_factorize(st, band)
    rhs = torch.randn(st.N, 3, dtype=dtype, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    kx = bk.solve(st, kf, rhs)
    px = plain.banded_solve(st, kf, rhs)
    torch.cuda.synchronize()
    assert (bk.banded_factorize_cuda.launches,
            bk.banded_solve_cuda.launches) == (before[0] + 1, before[1] + 1)
    for k, p in ((kf.band[:nb], pf.band[:nb]), (kf.invL[:nb], pf.invL[:nb]),
                 (kf.d, pf.d), (kx, px)):
        assert _rel(k, p) < RTOL[dtype]
    assert plain.banded_inertia(st, kf) == plain.banded_inertia(st, pf)


def test_wrappers_check_their_inputs():
    _need_cuda()
    st, band = _system(1, 4, 64, 1, torch.float64)
    f = plain.banded_factorize(st, band)
    with pytest.raises(TypeError):
        bk.banded_factorize_cuda(band.half(), f.invL, f.d, st.nb, 64, 1)
    with pytest.raises(ValueError):
        bk.banded_factorize_cuda(band, f.invL[:-1], f.d, st.nb, 64, 1)
    with pytest.raises(ValueError):
        bk.banded_solve_cuda(f.band, f.invL, f.d,
                             torch.zeros(3, st.nbp * 64, dtype=torch.float64,
                                         device="cuda").T)
    st48, band48 = _system(2, 3, 48, 1, torch.float64)
    with pytest.raises(ValueError):
        bk.factorize(st48, band48)


def test_solve_on_the_card_matches_the_cpu():
    _need_cuda()
    opts = dict(linear_solver=T.LinearSolver.BANDED, dtype="float64",
                print_level=T.PrintLevel.ERROR)
    cpu = T.madnlp(opf.build_sparse(nb=40, seed=2), device="cpu", **opts)
    bk.reset_counts()
    gpu = T.madnlp(opf.build_sparse(nb=40, seed=2), **opts)
    assert gpu.status == cpu.status == T.Status.SOLVE_SUCCEEDED
    assert gpu.iter == cpu.iter
    assert gpu.counters["factorization_cnt"] == cpu.counters["factorization_cnt"]
    assert abs(gpu.objective - cpu.objective) <= 1e-8 * abs(cpu.objective)
    # one more than the counter: the least-squares dual initialization
    assert bk.banded_factorize_cuda.launches == gpu.counters["factorization_cnt"] + 1
    assert bk.banded_solve_cuda.launches >= gpu.counters["backsolve_cnt"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", [(256, 2, 11), (128, 3, 5), (64, 1, 6),
                                     (32, 2, 9)])
def test_batched_kernels_match_plain_and_the_single_kernels(b, bw, nb, dtype):
    _need_cuda()
    st, band = _lanes(nb, b, bw, dtype)
    B = band.shape[0]
    active = np.ones(B, dtype=bool)
    before = (bk.banded_factorize_batched_cuda.launches,
              bk.banded_solve_batched_cuda.launches)
    kf = bk.factorize_batched(
        st, band.clone(), torch.zeros((B, st.nbp, b, b), dtype=dtype,
                                      device="cuda"),
        torch.ones((B, nb * b), dtype=dtype, device="cuda"), active)
    pf = plain.banded_factorize_batched(st, band)
    rhs = torch.randn(B, st.N, 2, dtype=dtype, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(1))
    kx = bk.solve_batched(st, kf, rhs, active)
    px = plain.banded_solve_batched(st, kf, rhs)
    torch.cuda.synchronize()
    assert (bk.banded_factorize_batched_cuda.launches,
            bk.banded_solve_batched_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
    for k, p in ((kf.band[:, :nb], pf.band[:, :nb]),
                 (kf.invL[:, :nb], pf.invL[:, :nb]), (kf.d, pf.d), (kx, px)):
        assert _rel(k, p) < RTOL[dtype]
    inertia = plain.banded_inertia(st, kf)
    assert (inertia == plain.banded_inertia(st, pf)).all()
    assert inertia[1, 1] == 1
    # each lane against the single-system kernels K1 / K2
    for i in range(B):
        f1 = bk.factorize(st, band[i].clone())
        x1 = bk.solve(st, f1, rhs[i])
        torch.cuda.synchronize()
        assert _rel(kf.band[i, :nb], f1.band[:nb]) < RTOL[dtype]
        assert _rel(kf.d[i], f1.d) < RTOL[dtype]
        assert _rel(kx[i], x1) < RTOL[dtype]
        assert tuple(inertia[i]) == plain.banded_inertia(st, f1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_kernels_leave_inactive_lanes_untouched(dtype):
    _need_cuda()
    st, band = _lanes(11, 256, 2, dtype)
    B, b, nb = band.shape[0], st.b, st.nb
    work = band.clone()
    invL = torch.full((B, st.nbp, b, b), 7.0, dtype=dtype, device="cuda")
    d = torch.full((B, nb * b), 3.0, dtype=dtype, device="cuda")
    active = np.array([False, True, True])
    f = bk.factorize_batched(st, work, invL, d, active)
    rhs = torch.randn(B, st.nbp * b, 1, dtype=dtype, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(2))
    r = rhs.clone()
    bk.banded_solve_batched_cuda(f.band, f.invL, f.d, r, active)
    torch.cuda.synchronize()
    assert torch.equal(f.band[0], band[0])
    assert (f.invL[0] == 7.0).all() and (f.d[0] == 3.0).all()
    assert torch.equal(r[0], rhs[0])
    full = plain.banded_factorize_batched(st, band)
    assert _rel(f.band[1:, :nb], full.band[1:, :nb]) < RTOL[dtype]


def test_solve_batch_on_the_card_matches_the_cpu():
    _need_cuda()
    opts = dict(linear_solver=T.LinearSolver.BANDED, dtype="float64",
                print_level=T.PrintLevel.ERROR)
    scales = [0.95, 1.0, 1.05]
    model = opf.build_sparse(nb=40, seed=2, parametric=True)
    cpu_solver = T.MadNLPSolver(model, device="cpu", **opts)
    cpu = T.batch_summary(cpu_solver.prob, cpu_solver.solve_batch(scales))
    gpu_solver = T.MadNLPSolver(model, **opts)
    bk.reset_counts()
    gpu = T.batch_summary(gpu_solver.prob, gpu_solver.solve_batch(scales))
    counts = bk.counts()
    assert (gpu["status"] == cpu["status"]).all()
    assert (gpu["iter"] == cpu["iter"]).all()
    assert (gpu["counters"]["factorization_cnt"]
            == cpu["counters"]["factorization_cnt"]).all()
    np.testing.assert_allclose(gpu["objective"], cpu["objective"], rtol=1e-8)
    assert counts["banded_factorize_batched_cuda"] > 0
    assert counts["banded_solve_batched_cuda"] > 0
    assert counts["banded_factorize_cuda"] == counts["banded_solve_cuda"] == 0


def _saddle(N, seed, dtype, zero_row=None):
    """A seeded saddle matrix [[H, Jᵀ], [J, -1e-3·I]] (H SPD, N/4 rows of
    J) on the card; ``zero_row`` zeroes a row and column (a zero pivot)."""
    rng = np.random.default_rng(seed)
    m = N // 4
    R = rng.standard_normal((N - m, N - m))
    J = rng.standard_normal((m, N - m))
    K = np.block([[R @ R.T + N * np.eye(N - m), J.T], [J, -1e-3 * np.eye(m)]])
    if zero_row is not None:
        K[zero_row, :] = 0.0
        K[:, zero_row] = 0.0
    return torch.as_tensor(K, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,block,zero_row", [(128, 128, None), (300, 128, 70),
                                              (700, 64, None), (97, 32, 40)])
def test_dense_ldlt_kernel_matches_plain(N, block, zero_row, dtype):
    _need_cuda()
    K = _saddle(N, N + block, dtype, zero_row)
    before = dk.dense_ldlt_cuda.launches
    kf = dk.dense_ldlt(K, block)
    pf = dk.dense_ldlt_plain(K, block)
    torch.cuda.synchronize()
    assert dk.dense_ldlt_cuda.launches == before + 1
    assert _rel(torch.tril(kf.L[:N, :N], -1), torch.tril(pf.L[:N, :N], -1)) \
        < RTOL[dtype]
    assert _rel(kf.d[:N], pf.d[:N]) < RTOL[dtype]
    m = N // 4
    expect = (N - m, 0, m) if zero_row is None else (N - m - 1, 1, m)
    assert ldlt_inertia(kf) == ldlt_inertia(pf) == expect


# K7 against its witness (its first version): N, block, zero pivot
WITNESS_CASES = [(128, 128, None), (300, 128, 70), (1000, 128, 500),
                 (700, 64, None), (700, 64, 350), (97, 32, 40), (256, 32, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,block,zero_row", WITNESS_CASES)
def test_dense_ldlt_equals_the_witness_bit_for_bit(N, block, zero_row, dtype):
    """The redesigned K7 and its first version give the same bits on the strict
    lower triangle and the diagonal, zero pivots included."""
    _need_cuda()
    K = _saddle(N, 3 * N + block, dtype, zero_row)
    dk.reset_counts()
    kf = dk.dense_ldlt(K, block)
    rf = dk.dense_ldlt_reference(K, block)
    torch.cuda.synchronize()
    assert dk.counts() == {"dense_ldlt_cuda": 1, "dense_ldlt_reference_cuda": 1}
    assert _same_bits(kf.L, rf.L)
    assert _same_bits(kf.d, rf.d)
    if zero_row is not None:
        assert int((kf.d[:N] == 0).sum()) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,block,zero_row", [(300, 48, None), (300, 100, 70),
                                              (50, 1, None), (130, 7, 20),
                                              (129, 128, None)])
def test_dense_ldlt_any_block_matches_plain(N, block, zero_row, dtype):
    """Blocks the witness does not take, against the plain version."""
    _need_cuda()
    K = _saddle(N, N + block, dtype, zero_row)
    kf = dk.dense_ldlt(K, block)
    pf = dk.dense_ldlt_plain(K, block)
    torch.cuda.synchronize()
    assert _rel(torch.tril(kf.L[:N, :N], -1), torch.tril(pf.L[:N, :N], -1)) \
        < RTOL[dtype]
    assert _rel(kf.d[:N], pf.d[:N]) < RTOL[dtype]
    m = N // 4
    expect = (N - m, 0, m) if zero_row is None else (N - m - 1, 1, m)
    assert ldlt_inertia(kf) == ldlt_inertia(pf) == expect


def test_dense_ldlt_wrapper_checks_its_inputs():
    _need_cuda()
    K = _saddle(256, 1, torch.float64)
    with pytest.raises(TypeError):
        dk.dense_ldlt_cuda(K.half(), 128)
    with pytest.raises(ValueError):
        dk.dense_ldlt_cuda(K[:, :128].contiguous(), 128)
    with pytest.raises(ValueError):
        dk.dense_ldlt_cuda(K.T[::2, ::2], 128)
    with pytest.raises(ValueError):
        dk.dense_ldlt_cuda(K, 256)
    with pytest.raises(ValueError, match="1..128"):
        dk.dense_ldlt(K, 129)
    with pytest.raises(ValueError):
        dk.dense_ldlt_cuda(K, 0)
    with pytest.raises(ValueError):
        dk.dense_ldlt_reference_cuda(K, 48)
    with pytest.raises(ValueError):
        dk.dense_ldlt_cuda(K.cpu(), 128)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dense_solve_on_the_card_matches_the_cpu(dtype):
    _need_cuda()
    opts = dict(dtype=dtype, print_level=T.PrintLevel.ERROR)
    cpu = T.madnlp(opf.build(nb=30, seed=1), device="cpu", **opts)
    bk.reset_counts()
    bf.reset_counts()
    dk.reset_counts()
    gpu = T.madnlp(opf.build(nb=30, seed=1), **opts)
    assert gpu.status == cpu.status == T.Status.SOLVE_SUCCEEDED
    assert gpu.iter == cpu.iter
    assert gpu.counters["factorization_cnt"] == cpu.counters["factorization_cnt"]
    assert abs(gpu.objective - cpu.objective) <= 1e-8 * abs(cpu.objective)
    # the dense path factors with K7: once per factorization, plus the
    # least-squares dual initialization's, which is not counted; K1-K6 and
    # K7's witness never
    counts = {**bk.counts(), **bf.counts(), **dk.counts()}
    assert counts.pop("dense_ldlt_cuda") == gpu.counters["factorization_cnt"] + 1
    assert not any(counts.values()), counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb,zero", [(64, 5, 10, False), (64, 5, 10, True),
                                          (256, 4, 8, False)])
def test_fused_kernels_match_plain_and_k1_k2(b, bw, nb, zero, dtype):
    _need_cuda()
    N = nb * b - b // 2
    rows, cols, vals = band_system(b + bw + nb, N, b, bw,
                                   zero_row=N // 2 if zero else None)
    st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
    band = st.assembly(st.map(rows, cols), "cpu")(
        torch.as_tensor(vals)).to(dtype).cuda()
    bf.reset_counts()
    ff = bf.banded_fused_factorize(st, band.clone())
    torch.cuda.synchronize()
    assert bf.counts()["banded_fused_factorize_cuda"] == 1
    pf = bf.banded_fused_factorize_plain(st, band)
    kf = bk.factorize(st, band.clone())
    for ref in (pf, kf):
        assert _rel(ff.band[:nb], ref.band[:nb]) < RTOL[dtype]
        assert _rel(ff.invL[:nb], ref.invL[:nb]) < RTOL[dtype]
        assert _rel(ff.d, ref.d) < RTOL[dtype]
        assert plain.banded_inertia(st, ff) == plain.banded_inertia(st, ref)
    assert plain.banded_inertia(st, ff)[1] == (1 if zero else 0)
    rng = np.random.default_rng(b + nb)
    for k in (1, 8, 130):
        rhs = torch.as_tensor(rng.standard_normal(N if k == 1 else (N, k)),
                              dtype=dtype, device="cuda")
        x = bf.banded_fused_solve(st, ff, rhs)
        assert x.shape == rhs.shape
        assert _rel(x, bf.banded_fused_solve_plain(st, ff, rhs)) < RTOL[dtype]
        assert _rel(x, _k2_solve(st, kf, rhs)) < RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", [(256, 2, 11), (64, 5, 10)])
def test_k1_and_k3_factors_equal_k5_bit_for_bit(b, bw, nb, dtype):
    """K1, K3 and K5 run the tiled diagonal step (K5's witness the scalar
    one it was rewritten from): the factors on the real columns must be
    equal, on a dominant band and on one with an exactly zero pivot (lane
    1)."""
    _need_cuda()
    st, bands = _lanes(nb, b, bw, dtype, zero_lane=1, lanes=2)
    B = bands.shape[0]
    kb = bk.factorize_batched(st, bands.clone(),
                              bands.new_zeros((B, st.nbp, b, b)),
                              bands.new_ones((B, nb * b)), np.ones(B, bool))
    for i in range(B):
        ff = bf.banded_fused_factorize(st, bands[i].clone())
        kf = bk.factorize(st, bands[i].clone())
        torch.cuda.synchronize()
        for f in (kf, plain.BandedFactor(kb.band[i], kb.invL[i], kb.d[i])):
            assert torch.equal(f.band[:nb], ff.band[:nb])
            assert torch.equal(f.invL[:nb], ff.invL[:nb])
            assert torch.equal(f.d, ff.d)
            assert plain.banded_inertia(st, f) == plain.banded_inertia(st, ff)
        assert plain.banded_inertia(st, ff)[1] == (1 if i == 1 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b", [32, 64, 128, 256])
def test_tiled_diagonal_step_equals_the_scalar_one(b, dtype):
    """The diagonal step alone, three blocks per launch (the second with an
    exactly zero pivot): the tiled routine equals the scalar one bit for
    bit and the plain version within the kernel tolerance."""
    _need_cuda()
    st, bands = _lanes(4, b, 1, dtype, zero_lane=1)
    A0 = bands[:, 1, 0].contiguous()      # block column 1 holds the zero
    out = {}
    for tiled in (True, False):
        A, R = A0.clone(), torch.empty_like(A0)
        d = A0.new_empty(A0.shape[:2])
        bk.banded_diag_step_cuda(A, R, d, tiled=tiled)
        out[tiled] = (A, R, d)
    torch.cuda.synchronize()
    for x, y in zip(out[True], out[False]):
        assert torch.equal(x, y)
    assert int((out[True][2][1] == 0).sum()) == 1
    for i in range(A0.shape[0]):
        LD, invL = plain.ldlt_with_inverse(A0[i].cpu())
        for x, r in zip(out[True], (LD, invL, torch.diagonal(LD))):
            assert _rel(x[i].cpu(), r) < RTOL[dtype]


def _k2_solve(st, f, rhs):
    """K2's solve of ``rhs``, eight columns at a time: K2 holds (bw+2)·b·k
    values of the right-hand side in each CTA's shared memory, too many for
    k = 130 at b = 256."""
    if rhs.ndim == 1:
        return bk.solve(st, f, rhs)
    return torch.cat([bk.solve(st, f, rhs[:, i:i + 8])
                      for i in range(0, rhs.shape[1], 8)], 1)


def test_fused_factorize_is_one_launch():
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    b, bw, nb = 64, 5, 10
    N = nb * b - b // 2
    rows, cols, vals = band_system(7, N, b, bw)
    st = plain.BandStructure(rows, cols, N, block=b, perm=np.arange(N))
    band = st.assembly(st.map(rows, cols), "cpu")(
        torch.as_tensor(vals)).float().cuda()
    invL = torch.zeros((st.nbp, b, b), device="cuda")
    d = torch.ones((st.nbp * b,), device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bf.banded_fused_factorize_cuda(band, invL, d, nb, b, bw)
        torch.cuda.synchronize()
    kernels = [ev for ev in prof.events()
               if getattr(ev, "device_type", None)
               == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [ev.name for ev in kernels]


def test_fused_wrappers_check_their_inputs():
    _need_cuda()
    st, band = _system(3, 4, 64, 2, torch.float64)
    invL = torch.zeros((st.nbp, 64, 64), dtype=torch.float64, device="cuda")
    d = torch.ones((st.nbp * 64,), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        bf.banded_fused_factorize_cuda(band.half(), invL, d, st.nb, 64, st.bw)
    with pytest.raises(ValueError):
        bf.banded_fused_factorize_cuda(band, invL[1:], d, st.nb, 64, st.bw)
    with pytest.raises(ValueError):
        bf.banded_fused_solve_cuda(band, invL, d, torch.zeros(
            (st.nbp * 64, 3), dtype=torch.float64, device="cuda"))


# the JAX package's case118 solve on the CPU in the bench configuration
# (banded KKT, float32, μ-scaled Richardson) in the TPU kernel's
# factorization order (``banded_backend="pallas_interpret"``), which the
# port follows: status, iterations, factorizations, backsolves, objective
# (chip_smoke.py:MATPOWER_REFERENCE)
CASE118_FLOAT32 = ("SOLVE_SUCCEEDED", 15, 15, 34, 129660.68493585243)


def test_case118_bench_solve_on_the_card_matches_jax():
    _need_cuda()
    path = os.path.join(os.path.dirname(__file__), "data", "case118.m")
    bk.reset_counts()
    bf.reset_counts()
    s = T.madnlp(matpower.load_acopf(path), linear_solver=T.LinearSolver.BANDED,
                 dtype="float32", richardson=T.RichardsonOptions(mu_scaled=True),
                 print_level=T.PrintLevel.ERROR)
    status, iters, facts, backs, obj = CASE118_FLOAT32
    assert (s.status.name, s.iter, s.counters["factorization_cnt"]) == \
        (status, iters, facts)
    assert abs(s.counters["backsolve_cnt"] - backs) <= 0.06 * backs
    assert abs(s.objective - obj) <= 1e-8 * abs(obj)
    assert bk.banded_factorize_cuda.launches == facts + 1
    assert not any(bf.counts().values())


# K2 and K4 against their witness: the geometries of the flagship, the
# case118×4 ring, a wide band, case118 and a narrow block
SOLVE_GEOMETRIES = [(256, 2, 11), (256, 4, 10), (128, 7, 12), (64, 5, 10),
                    (32, 2, 9)]
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(_BITS[a.dtype]),
                                              b.view(_BITS[b.dtype]))


def _factored_lanes(nb, b, bw, dtype, k):
    """Three factored lanes (lane 1 with an exactly zero pivot) and a
    seeded zero-padded right-hand side (3, (nb+bw)·b, k)."""
    st, bands = _lanes(nb, b, bw, dtype, zero_lane=1)
    B = bands.shape[0]
    f = bk.factorize_batched(st, bands.clone(),
                             bands.new_zeros((B, st.nbp, b, b)),
                             bands.new_ones((B, nb * b)), np.ones(B, bool))
    rng = np.random.default_rng(b + bw + nb + k)
    rhs = plain.pad_rhs_batched(st, torch.as_tensor(
        rng.standard_normal((B, st.N, k)), dtype=dtype, device="cuda"))
    return st, f, rhs


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", SOLVE_GEOMETRIES)
def test_cluster_solve_equals_the_reference_bit_for_bit(b, bw, nb, dtype, k):
    """K4 on three lanes (one with a zero pivot) and K2 on each lane equal
    the one-CTA reference solve bit for bit, padding rows included."""
    _need_cuda()
    st, f, rhs = _factored_lanes(nb, b, bw, dtype, k)
    every = np.ones(rhs.shape[0], bool)
    new, ref = rhs.clone(), rhs.clone()
    bk.banded_solve_batched_cuda(f.band, f.invL, f.d, new, every)
    bk.banded_solve_reference_cuda(f.band, f.invL, f.d, ref, every)
    torch.cuda.synchronize()
    assert _same_bits(new, ref)
    assert not new[:, st.nb * b:].any() and torch.isfinite(new).all()
    for i in range(rhs.shape[0]):
        x, y = rhs[i].clone(), rhs[i].clone()
        bk.banded_solve_cuda(f.band[i], f.invL[i], f.d[i], x)
        bk.banded_solve_reference_cuda(f.band[i], f.invL[i], f.d[i], y)
        torch.cuda.synchronize()
        assert _same_bits(x, y) and _same_bits(x, new[i])
    assert _rel(new, plain.solve_padded_batched(
        f.band, f.invL, f.d, rhs.clone(), every)) < RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cluster_solve_leaves_inactive_lanes_untouched(dtype):
    _need_cuda()
    st, f, rhs = _factored_lanes(11, 256, 2, dtype, 1)
    active = np.array([False, True, True])
    new, ref = rhs.clone(), rhs.clone()
    bk.banded_solve_batched_cuda(f.band, f.invL, f.d, new, active)
    bk.banded_solve_reference_cuda(f.band, f.invL, f.d, ref, active)
    torch.cuda.synchronize()
    assert _same_bits(new, ref)
    assert _same_bits(new[0], rhs[0])
    assert not _same_bits(new[1], rhs[1])


def test_solves_launch_the_cluster_kernel_once_per_call():
    """solve and solve_batched: one launch of the cluster kernel per call
    (counted by the wrapper and by torch.profiler), the witness never."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    st, f, rhs = _factored_lanes(11, 256, 2, torch.float32, 1)
    single = plain.BandedFactor(f.band[0].contiguous(), f.invL[0].contiguous(),
                                f.d[0].contiguous())
    every = np.ones(rhs.shape[0], bool)
    x1 = rhs[0, :st.N, 0].contiguous()
    xb = rhs[:, :st.N].contiguous()
    bk.solve(st, single, x1)          # builds, plans and warms up
    torch.cuda.synchronize()
    bk.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bk.solve(st, single, x1)
        bk.solve_batched(st, f, xb, every)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None)
             == torch.autograd.DeviceType.CUDA]
    assert sum("cluster_solve_kernel" in n for n in names) == 2, names
    assert not any("solve_reference_kernel" in n for n in names), names
    counts = bk.counts()
    assert counts["banded_solve_cuda"] == counts["banded_solve_batched_cuda"] == 1
    assert counts["banded_solve_reference_cuda"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", [(256, 2, 11), (256, 4, 10)])
def test_cluster_solve_of_twelve_columns_is_twelve_one_column_solves(
        b, bw, nb, dtype):
    """K2 at k = 12, the compact L-BFGS SMW solve's width (2·max_history),
    at the flagship's and the ring's geometry: each column bit for bit the
    one-column launch, and within RTOL of the plain solve."""
    _need_cuda()
    st, band = _system(b + bw + nb, nb, b, bw, dtype)
    f = bk.factorize(st, band.clone())
    rng = np.random.default_rng(12)
    rhs = torch.as_tensor(rng.standard_normal((st.N, 12)), dtype=dtype,
                          device="cuda")
    wide = plain.pad_rhs(st, rhs)
    x = wide.clone()
    bk.banded_solve_cuda(f.band, f.invL, f.d, x)
    for j in range(12):
        xj = wide[:, j:j + 1].clone()
        bk.banded_solve_cuda(f.band, f.invL, f.d, xj)
        torch.cuda.synchronize()
        assert _same_bits(x[:, j:j + 1], xj), j
    assert _rel(x[: st.N], plain.banded_solve(st, f, rhs)) < RTOL[dtype]


def test_solve_wrappers_raise_where_no_plan_fits():
    _need_cuda()
    st, f, rhs = _factored_lanes(11, 256, 2, torch.float64, 1)
    wide = torch.zeros((3, st.nbp * st.b, 200), dtype=torch.float64,
                       device="cuda")
    before = (bk.banded_solve_cuda.launches,
              bk.banded_solve_batched_cuda.launches)
    with pytest.raises(ValueError):
        bk.banded_solve_cuda(f.band[0], f.invL[0], f.d[0], wide[0])
    with pytest.raises(ValueError):
        bk.banded_solve_batched_cuda(f.band, f.invL, f.d, wide,
                                     np.ones(3, bool))
    assert (bk.banded_solve_cuda.launches,
            bk.banded_solve_batched_cuda.launches) == before


# K5 and K6 against their witnesses (the one-CTA kernels they replaced):
# the kernel phase's geometries, case118's, the ring's and a narrow block
FUSED_GEOMETRIES = [(256, 2, 11), (256, 4, 8), (128, 7, 12), (64, 1, 12),
                    (64, 5, 10), (32, 2, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", FUSED_GEOMETRIES)
def test_fused_factorize_equals_its_witness_bit_for_bit(b, bw, nb, dtype):
    """K5 (one cluster) equals its witness and K1 bit for bit on a dominant
    band and on one with an exactly zero pivot (lane 1), overhang included,
    in one launch per call."""
    _need_cuda()
    st, bands = _lanes(nb, b, bw, dtype, zero_lane=1, lanes=2)
    for i in range(bands.shape[0]):
        out = []
        for fn in (bf.banded_fused_factorize_cuda,
                   bf.banded_fused_factorize_reference_cuda,
                   bk.banded_factorize_cuda):
            band = bands[i].clone()
            invL = torch.zeros((st.nbp, b, b), dtype=dtype, device="cuda")
            d = torch.ones((st.nbp * b,), dtype=dtype, device="cuda")
            bf.reset_counts()
            fn(band, invL, d, nb, b, bw)
            torch.cuda.synchronize()
            out.append((band, invL, d))
            if fn is bf.banded_fused_factorize_cuda:
                assert bf.counts()["banded_fused_factorize_cuda"] == 1
                assert not any(bf.witness_counts().values())
        new, ref, k1 = out
        for x, y in zip(new, ref):
            assert _same_bits(x, y)
        for x, y in zip(new, k1):
            assert _same_bits(x[:nb], y[:nb])
        f = plain.BandedFactor(new[0], new[1], new[2][: nb * b])
        assert plain.banded_inertia(st, f)[1] == (1 if i == 1 else 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b,bw,nb", FUSED_GEOMETRIES)
def test_fused_solve_equals_its_witness_bit_for_bit(b, bw, nb, dtype):
    """K6 (a cluster per tile of columns) equals its witness bit for bit,
    overhang rows included, at 1, 8 and 130 right-hand sides, on a factor
    with an exactly zero pivot, in one launch per call."""
    _need_cuda()
    st, bands = _lanes(nb, b, bw, dtype, zero_lane=0, lanes=1)
    f = bf.banded_fused_factorize(st, bands[0].clone())
    rng = np.random.default_rng(b + bw + nb)
    for k in (1, 8, 130):
        rhs = torch.as_tensor(rng.standard_normal((st.N, k)), dtype=dtype,
                              device="cuda")
        x, dpad = bf._padded(st, f, rhs)
        y, z = x.clone(), x.clone()
        bf.reset_counts()
        bf.banded_fused_solve_cuda(f.band, f.invL, dpad, x, k)
        torch.cuda.synchronize()
        assert bf.counts()["banded_fused_solve_cuda"] == 1
        assert not any(bf.witness_counts().values())
        bf.banded_fused_solve_cuda(f.band, f.invL, dpad, z)   # every column
        bf.banded_fused_solve_reference_cuda(f.band, f.invL, dpad, y)
        torch.cuda.synchronize()
        assert _same_bits(x, y), (k, bf.solve_plan_for(f.band, k))
        assert _same_bits(z, y), (k, bf.solve_plan_for(f.band, z.shape[1]))
        assert torch.isfinite(x).all()


def test_fused_kernels_are_one_device_launch_each():
    """One K5 call and one K6 call are one CUDA kernel each (the profiler's
    count), the witnesses none."""
    _need_cuda()
    from torch.profiler import ProfilerActivity, profile

    st, bands = _lanes(10, 64, 5, torch.float32, zero_lane=None, lanes=1)
    rhs = torch.ones(st.N, device="cuda")
    bf.banded_fused_solve(st, bf.banded_fused_factorize(st, bands[0].clone()),
                          rhs)                       # builds and plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f = bf.banded_fused_factorize(st, bands[0].clone())
        bf.banded_fused_solve(st, f, rhs)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if getattr(ev, "device_type", None)
             == torch.autograd.DeviceType.CUDA]
    assert sum("cluster_factorize_kernel" in n for n in names) == 1, names
    assert sum("cluster_fused_solve_kernel" in n for n in names) == 1, names
    assert not any("fused_factorize_kernel" in n or "fused_solve_kernel" in n
                   for n in names if "cluster" not in n), names


# -- restoration, warm start and checkpoints on the card ----------------------


def _restoration_solver():
    """``opf.build_sparse(nb=118, seed=0, parametric=True)`` on the card,
    banded, float64: at load scale 2.0 it is infeasible, and the solve
    passes through soft and robust restoration."""
    return T.MadNLPSolver(opf.build_sparse(nb=118, seed=0, parametric=True),
                          linear_solver=T.LinearSolver.BANDED,
                          richardson=T.RichardsonOptions(mu_scaled=True),
                          print_level=T.PrintLevel.ERROR)


def _counting_least_squares(solver):
    """Count the least-squares multiplier solves (one uncounted
    factorization each: the start and every return from robust
    restoration to the regular phase)."""
    calls = []
    inner = solver.kernel._least_squares_duals

    def counted(st):
        calls.append(1)
        return inner(st)

    solver.kernel._least_squares_duals = counted
    return calls


def test_restoration_solve_on_the_card():
    """Bit for bit on a repeat; K1 once per factorization (and per
    least-squares solve), K2 at least once per backsolve; K5-K7 and every
    witness never."""
    _need_cuda()
    runs = []
    for _ in range(2):
        solver = _restoration_solver()
        lsq = _counting_least_squares(solver)
        bk.reset_counts()
        bf.reset_counts()
        dk.reset_counts()
        stats = solver.solve(params=2.0)
        runs.append((stats, {**bk.counts(), **bf.counts(),
                             **bf.witness_counts(), **dk.counts()}, len(lsq)))
    (a, counts, lsq), (b, _, _) = runs
    assert a.status == T.Status.INFEASIBLE_PROBLEM_DETECTED
    assert a.counters == b.counters and a.objective == b.objective
    assert np.array_equal(a.solution, b.solution)
    assert np.array_equal(a.multipliers, b.multipliers)
    assert lsq > 1       # the start and at least one return to regular
    assert counts.pop("banded_factorize_cuda") == \
        a.counters["factorization_cnt"] + lsq
    assert counts.pop("banded_solve_cuda") >= a.counters["backsolve_cnt"]
    assert not any(counts.values()), counts


def test_batch_restoration_on_the_card():
    """``solve_batch`` at (1.0, 2.0) on the card: the 2.0 lane restores
    inside the batch.  Each lane is the port's single solve of its scale
    on the card: status, iterations and factorizations exactly, objective
    within 1e-8 relative, backsolves exactly on the 1.0 lane and on the
    2.0 lane inside its one-ulp spread, 195-198, which single and batched
    solves share (``tools/spread.py restoration --pkg port|batch --nb 118``,
    seeds 0-6 on the card; every other count of those 14 solves is one
    number).  K3/K4 launched; K1/K2, K5-K7 and every witness never."""
    _need_cuda()
    single = [_restoration_solver().solve(params=p) for p in (1.0, 2.0)]
    assert single[1].status == T.Status.INFEASIBLE_PROBLEM_DETECTED
    solver = _restoration_solver()
    bk.reset_counts()
    bf.reset_counts()
    dk.reset_counts()
    summ = T.batch_summary(solver.prob, solver.solve_batch([1.0, 2.0]))
    counts = {**bk.counts(), **bf.counts(), **bf.witness_counts(),
              **dk.counts()}
    c = summ["counters"]
    for i, s in enumerate(single):
        assert summ["status"][i] == int(s.status)
        assert summ["iter"][i] == s.iter
        assert c["factorization_cnt"][i] == s.counters["factorization_cnt"]
        if i == 0:
            assert c["backsolve_cnt"][i] == s.counters["backsolve_cnt"]
        else:
            assert 195 <= c["backsolve_cnt"][i] <= 198
            assert 195 <= s.counters["backsolve_cnt"] <= 198
        assert abs(summ["objective"][i] - s.objective) \
            <= 1e-8 * abs(s.objective)
    assert counts.pop("banded_factorize_batched_cuda") > 0
    assert counts.pop("banded_solve_batched_cuda") > 0
    assert not any(counts.values()), counts


def test_checkpoint_round_trip_on_the_card(tmp_path):
    """Saved inside robust restoration, loaded back onto the card into a
    fresh solver and finished there: bit for bit the uninterrupted
    solve."""
    _need_cuda()
    from madnlp_tpu_torch.utils.checkpoint import resume, save_state
    from madnlp_tpu_torch.utils.status import Status as S

    def steps(solver, st, n=None):
        k = solver.kernel
        step = {int(S.REGULAR): k.regular_step, int(S.RESTORE): k.restore_step,
                int(S.ROBUST): k.robust_step}
        done = 0
        while st.status in step and (n is None or done < n):
            st = step[st.status](st)
            done += 1
        return st

    whole = _restoration_solver().solve(params=2.0)
    first = _restoration_solver()
    st = first.kernel.initialize(first._params(2.0))
    # step until robust restoration is set up and continues
    while (st.status in (int(S.REGULAR), int(S.RESTORE))
           or (st.status == int(S.ROBUST) and st.rr_init_needed)):
        st = steps(first, st, 1)
    assert st.status == int(S.ROBUST)
    path = str(tmp_path / "state.npz")
    save_state(st, path)
    second = _restoration_solver()
    st2 = resume(second, path)
    assert st2.x.device.type == "cuda" and st2.RR.pp.device.type == "cuda"
    assert torch.equal(st2.x, st.x) and torch.equal(st2.RR.zp, st.RR.zp)
    st2 = steps(second, st2)
    again = second._stats(st2, 0.0)
    assert again.status == whole.status
    assert again.counters == whole.counters
    assert np.array_equal(again.solution, whole.solution)


@pytest.mark.parametrize("opts,nb,scales", [
    ({"barrier": T.BarrierUpdate.QUALITY_FUNCTION}, 118, (0.95, 1.0, 1.05)),
    ({"hessian_approximation": T.HessianApproximation.COMPACT_LBFGS}, 14,
     tuple(np.linspace(0.92, 1.08, 16))),
], ids=["quality_function", "compact_lbfgs"])
def test_batch_step_options_on_the_card(opts, nb, scales):
    """``solve_batch`` of the parametric ACOPF on the card under a step
    option: each lane is the port's single solve of its scale on the card
    (status, iterations and factorizations exactly, the objective within
    1e-8 relative, backsolves within one sweep); K3/K4 launched, under
    compact L-BFGS K4 once per batched factorization on the 12 columns of
    the SMW payload; K1/K2, K5-K7 and every witness never.  The quality
    function runs the nb=118 model at three scales; compact L-BFGS the
    nb=14 model at the 16 scales of ``chip_smoke.py``'s batch, where on
    the card every lane equals its single solve (at nb=118 and nb=30 a
    quasi-Newton lane's exit moves with rounding: ROADMAP C4)."""
    _need_cuda()

    def solver():
        return T.MadNLPSolver(
            opf.build_sparse(nb=nb, seed=0, parametric=True), device="cuda",
            linear_solver=T.LinearSolver.BANDED,
            richardson=T.RichardsonOptions(mu_scaled=True),
            print_level=T.PrintLevel.ERROR, **opts)

    one = solver()
    single = []
    for p in scales:
        one.state = None
        single.append(one.solve(params=float(p)))
    widths = {}
    solve_batched = bk.solve_batched

    def counting(struct, f, rhs, active):
        k = 1 if rhs.ndim == 2 else rhs.shape[2]
        widths[k] = widths.get(k, 0) + 1
        return solve_batched(struct, f, rhs, active)

    s = solver()
    bk.reset_counts()
    bf.reset_counts()
    dk.reset_counts()
    bk.solve_batched = counting
    try:
        summ = T.batch_summary(s.prob, s.solve_batch(scales))
    finally:
        bk.solve_batched = solve_batched
    counts = {**bk.counts(), **bf.counts(), **bf.witness_counts(),
              **dk.counts()}
    c = summ["counters"]
    for i, ref in enumerate(single):
        assert ref.status == T.Status.SOLVE_SUCCEEDED
        assert summ["status"][i] == int(ref.status)
        assert summ["iter"][i] == ref.iter
        assert c["factorization_cnt"][i] == ref.counters["factorization_cnt"]
        assert abs(c["backsolve_cnt"][i] - ref.counters["backsolve_cnt"]) <= 1
        assert abs(summ["objective"][i] - ref.objective) \
            <= 1e-8 * abs(ref.objective)
    k3 = counts.pop("banded_factorize_batched_cuda")
    assert k3 > 0 and counts.pop("banded_solve_batched_cuda") > 0
    assert not any(counts.values()), counts
    if "hessian_approximation" in opts:
        assert widths.get(12, 0) == k3
        assert (c["hess_cnt"] == 0).all()
    else:
        assert 12 not in widths


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_cluster_solve_of_twelve_columns(dtype):
    """K4 at k = 12 over 16 lanes of the nb600 batch's geometry (b = 256,
    bw = 2, nb = 11), lane 3 inactive: each column bit for bit the
    one-column K4 launch, the inactive lane's right-hand side back bit for
    bit, the active lanes within RTOL of the plain solve."""
    _need_cuda()
    st, bands = _lanes(11, 256, 2, dtype, zero_lane=None, lanes=16)
    f = bk.factorize_batched(st, bands.clone(),
                             bands.new_zeros((16, st.nbp, st.b, st.b)),
                             bands.new_ones((16, st.nb * st.b)),
                             np.ones(16, bool))
    active = np.ones(16, dtype=bool)
    active[3] = False
    rng = np.random.default_rng(16)
    rhs = torch.as_tensor(rng.standard_normal((16, st.N, 12)), dtype=dtype,
                          device="cuda")
    wide = plain.pad_rhs_batched(st, rhs)
    x = wide.clone()
    bk.banded_solve_batched_cuda(f.band, f.invL, f.d, x, active)
    for j in range(12):
        xj = wide[:, :, j:j + 1].clone()
        bk.banded_solve_batched_cuda(f.band, f.invL, f.d, xj, active)
        torch.cuda.synchronize()
        assert _same_bits(x[:, :, j:j + 1], xj), j
    assert _same_bits(x[3], wide[3])
    ref = plain.banded_solve_batched(st, f, rhs, active)
    for i in np.flatnonzero(active):
        assert _rel(x[i, : st.N], ref[i]) < RTOL[dtype]


def test_minsurf_nl_band_kernels_match_plain(tmp_path):
    """``minsurf_nl(100)`` (n = 10,201) through ``solve_nl`` on the card in
    float64: K1 once per factorization, K2 once per backsolve, no other
    kernel; its KKT band has b = 256, bw = 1, nb = 40 (a geometry no other
    solve path runs); K1/K2 on its last band against their plain
    versions within 1e-6 (the solve's own ill-conditioned matrix), the
    inertia equal."""
    from madnlp_tpu_torch.models import nl
    from madnlp_tpu_torch.testing import minsurf_nl

    _need_cuda()
    path = tmp_path / "minsurf.nl"
    path.write_text(minsurf_nl(100))
    kept = {}
    factorize = bk.factorize

    def keeping(struct, band):
        kept["struct"], kept["band"] = struct, band.clone()
        return factorize(struct, band)

    bk.factorize = keeping
    bk.reset_counts()
    dk.reset_counts()
    try:
        stats = nl.solve_nl(str(path), device="cuda",
                            print_level=T.PrintLevel.ERROR)
    finally:
        bk.factorize = factorize
    counts = {**bk.counts(), **dk.counts()}
    assert stats.status == T.Status.SOLVE_SUCCEEDED
    assert counts.pop("banded_factorize_cuda") == \
        stats.counters["factorization_cnt"]
    assert counts.pop("banded_solve_cuda") == stats.counters["backsolve_cnt"]
    assert not any(counts.values()), counts
    st, band = kept["struct"], kept["band"]
    assert (st.b, st.bw, st.nb) == (256, 1, 40)
    kf = bk.factorize(st, band.clone())
    pf = plain.banded_factorize(st, band)
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(st.N),
                          device="cuda")
    for a, ref in ((kf.band[: st.nb], pf.band[: st.nb]),
                   (kf.invL[: st.nb], pf.invL[: st.nb]), (kf.d, pf.d),
                   (bk.solve(st, kf, rhs), plain.banded_solve(st, kf, rhs))):
        assert _rel(a, ref) < 1e-6
    assert plain.banded_inertia(st, kf) == plain.banded_inertia(st, pf)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_banded_harness_round_trip_on_the_card(dtype):
    """``testing.test_kkt_system`` on the banded SPARSE system on the card
    (K1 and K2, one launch each), float32 to 1e-5 (no refinement)."""
    import madnlp_tpu_torch.testing as mt
    from madnlp_tpu_torch.models.instances import sparse_qp

    _need_cuda()
    bk.reset_counts()
    assert mt.test_kkt_system(
        model=sparse_qp.build(n=1000), kkt_system=T.KKTSystem.SPARSE,
        linear_solver=T.LinearSolver.BANDED, device="cuda", dtype=dtype,
        rtol=1e-5 if dtype == "float32" else 1e-8)
    counts = bk.counts()
    assert counts["banded_factorize_cuda"] == 1
    assert counts["banded_solve_cuda"] == 1


# -- slice A4: the range-space solvers and the new KKT systems ----------------


@pytest.mark.parametrize("solver", [T.LinearSolver.BLOCK_CHOLESKY,
                                    T.LinearSolver.HYKKT])
def test_range_space_harness_on_the_card(solver):
    """``testing.test_linear_solver`` for BLOCK_CHOLESKY and HYKKT on the
    card: HYKKT's K_γ through K7 (the card's default backend, one
    launch), no Cholesky; BLOCK_CHOLESKY launches no kernel of the port."""
    import madnlp_tpu_torch.testing as mt

    _need_cuda()
    dk.reset_counts()
    assert mt.test_linear_solver(solver, device="cuda")
    want = 1 if solver == T.LinearSolver.HYKKT else 0
    assert dk.counts()["dense_ldlt_cuda"] == want


@pytest.mark.parametrize("kkt,lin,kernels", [
    ("sparse_unreduced", "banded", "K1K2"),
    ("sparse_condensed", "banded", "K1K2"),
    ("sparse_unreduced", "ldl", "K7"),
    ("dense", "hykkt", "K7"),
])
def test_a4_harness_round_trip_on_the_card(kkt, lin, kernels):
    """``testing.test_kkt_system`` on the A4 systems on the card: the
    banded ones through K1 and K2 (one launch each), the dense ones
    through K7 (HYKKT: its K_γ)."""
    import madnlp_tpu_torch.testing as mt
    from madnlp_tpu_torch.models.instances import sparse_qp

    _need_cuda()
    bk.reset_counts()
    dk.reset_counts()
    model = sparse_qp.build(n=1000) if lin == "banded" else None
    assert mt.test_kkt_system(model=model, kkt_system=kkt,
                              linear_solver=lin, device="cuda")
    counts = {k: v for k, v in {**bk.counts(), **dk.counts()}.items() if v}
    want = ({"banded_factorize_cuda": 1, "banded_solve_cuda": 1}
            if kernels == "K1K2" else {"dense_ldlt_cuda": 1})
    assert counts == want


@pytest.mark.parametrize("opts", [
    dict(kkt_system="sparse_unreduced", linear_solver="banded"),
    dict(kkt_system="sparse_condensed", linear_solver="banded", tol=1e-6),
])
def test_a4_banded_solve_on_the_card_matches_the_cpu(opts):
    """The nb=30 sparse ACOPF under the unreduced and the condensed system
    on K1/K2 against the same solve on the CPU: the status, the objective
    within 1e-8; the unreduced iterations and factorizations exactly and
    its backsolves within 2% (the condensed counts move with rounding,
    ROADMAP §C R3); K1 once per factorization and K2 once per backsolve at
    least."""
    _need_cuda()
    o = dict(print_level=T.PrintLevel.ERROR, **opts)
    cpu = T.madnlp(opf.build_sparse(nb=30, seed=1), device="cpu", **o)
    bk.reset_counts()
    gpu = T.madnlp(opf.build_sparse(nb=30, seed=1), **o)
    assert gpu.status == cpu.status == T.Status.SOLVE_SUCCEEDED
    assert abs(gpu.objective - cpu.objective) <= 1e-8 * abs(cpu.objective)
    if opts["kkt_system"] == "sparse_unreduced":
        # float64 refinement sweeps at the operator's rounding floor move
        # by one between devices (ROADMAP §C, C1)
        assert gpu.iter == cpu.iter
        assert (gpu.counters["factorization_cnt"]
                == cpu.counters["factorization_cnt"])
        assert abs(gpu.counters["backsolve_cnt"]
                   - cpu.counters["backsolve_cnt"]) <= 0.02 * cpu.counters[
                       "backsolve_cnt"]
    c = bk.counts()
    assert c["banded_factorize_cuda"] >= gpu.counters["factorization_cnt"]
    assert c["banded_solve_cuda"] >= gpu.counters["backsolve_cnt"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hykkt_solve_on_the_card_launches_k7(dtype, monkeypatch):
    """The dense nb=30 ACOPF under DENSE + HYKKT on the card (the default
    backend "ldl"): K_γ through K7 once per factorization plus the
    least-squares start's, never a Cholesky; the counts equal the CPU's
    solve with ``hykkt_backend="ldl"`` (K7's plain version)."""
    _need_cuda()
    o = dict(print_level=T.PrintLevel.ERROR, kkt_system="dense",
             linear_solver="hykkt", dtype=dtype)
    cpu = T.madnlp(opf.build(nb=30, seed=1), device="cpu",
                   hykkt_backend="ldl", **o)

    def no_cholesky(*args, **kwargs):
        raise AssertionError("a Cholesky ran under hykkt_backend='ldl'")
    monkeypatch.setattr(torch.linalg, "cholesky_ex", no_cholesky)
    dk.reset_counts()
    gpu = T.madnlp(opf.build(nb=30, seed=1), **o)
    assert gpu.status == cpu.status == T.Status.SOLVE_SUCCEEDED
    assert abs(gpu.objective - cpu.objective) <= 1e-8 * abs(cpu.objective)
    assert dk.counts()["dense_ldlt_cuda"] == (
        gpu.counters["factorization_cnt"] + 1)
    if dtype == "float64":
        assert gpu.iter == cpu.iter
        assert (gpu.counters["factorization_cnt"]
                == cpu.counters["factorization_cnt"])
