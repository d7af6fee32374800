"""The launch plans of the whole-band kernels K5 and K6
(``madnlp_tpu_torch/ops/banded_fused_kernels.py:fused_factorize_plan`` and
``fused_solve_plan``), pure Python: every geometry and width the kernels
take has a plan that fits the shared memory a CTA may use; case118's band
in float32 is resident in both; the b = 256 geometries stream; an
impossible request raises.

``H100`` is the residency an NVIDIA H100 80GB HBM3 reports at one CTA per
SM (``banded_kernels.max_clusters``, by ``cudaOccupancyMaxActiveClusters``);
``NO_16`` a card that keeps no cluster of 16.
"""

import itertools

import pytest
import torch

from madnlp_tpu_torch.ops import banded_fused_kernels as bf
from madnlp_tpu_torch.ops import banded_kernels as bk

torch.set_num_threads(1)

H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
NO_16 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 0}
WIDTHS = (1, 8, 130)          # right-hand sides, as chip_smoke.py runs K6
CASE118 = (64, 5, 10)         # (b, bw, nb) of case118's KKT band


def _factor_smem(plan, b, bw, nb, item):
    """K5's shared memory recomputed from csrc/banded_fused.cu's layout:
    the scratch (the diagonal step's, banded_diag.cuh, or the products'
    two slices of both operands, whichever is larger), then, where
    resident, the CTA's off-diagonal blocks and panel blocks."""
    diag = 32 * 33 + 32 * 32 + 32 * 36 + 32 + 3 * 32 * b
    scratch = max(diag, 2 * 2 * 32 * 68)
    C = plan.clusters
    blocks = -(-(nb + bw) * bw // C) + -(-bw // C) if plan.resident else 0
    return (scratch + blocks * b * b) * item


def _solve_smem(plan, b, bw, item):
    """K6's shared memory recomputed from csrc/banded_fused.cu's layout:
    its mbarriers (three and one per stage, in 128-byte units), the stages,
    the x window and r (bw+1 blocks), z (two buffers), the partial sums
    (256 / b chains per owned column)."""
    nr = b // plan.clusters
    bars = -(-(3 + plan.stages) * 8 // 128) * 128
    return bars + (plan.stages * plan.rows * b + (bw + 3) * b * plan.cols
                   + nr * (256 // b) * plan.cols) * item


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [H100, NO_16])
def test_every_supported_geometry_has_a_factorize_plan_that_fits(dtype, cap):
    item = torch.empty((), dtype=dtype).element_size()
    for b, bw, nb in itertools.product(bk.SUPPORTED_BLOCKS, range(1, 8),
                                       (1, 2, 10, 30)):
        plan = bf.fused_factorize_plan(b, bw, nb, dtype, cap)
        C = plan.clusters
        assert plan.smem == _factor_smem(plan, b, bw, nb, item) \
            <= bk.SMEM_LIMIT
        assert C in bk.CLUSTER_SIZES and (C == 1 or cap[C] >= 1)
        # no more CTAs than the trailing tiles and the diagonal step use
        assert C <= bw * (bw + 1) // 2 * max(1, b // 64) ** 2 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [H100, NO_16])
def test_every_supported_geometry_has_a_solve_plan_that_fits(dtype, cap):
    item = torch.empty((), dtype=dtype).element_size()
    for b, bw, nb, k in itertools.product(bk.SUPPORTED_BLOCKS, range(1, 8),
                                          (1, 10, 30), WIDTHS):
        plan = bf.fused_solve_plan(b, bw, nb, k, dtype, cap)
        C, nr = plan.clusters, b // plan.clusters
        tiles = -(-k // plan.cols)
        assert plan.smem == _solve_smem(plan, b, bw, item) <= bk.SMEM_LIMIT
        assert b % C == 0 and nr * item % 16 == 0
        # the tiles stay inside the padded width
        assert 8 % plan.cols == 0 and tiles * plan.cols <= bf.pad_width(k)
        assert C == 1 or tiles <= cap[C]
        assert 1 <= plan.rows <= (bw + 1) * nr
        if plan.resident:
            # one stage per chunk: a CTA's whole share of each block column
            assert plan.rows == (bw + 1) * nr and plan.stages == 2 * nb
        else:
            box = 1 << (min(nr, plan.rows, 16).bit_length() - 1)
            assert plan.rows % box == 0
            assert 2 <= plan.stages <= bf.MAX_STAGES


def test_case118_float32_is_resident():
    """case118's band in float32: K5 keeps its off-diagonal blocks in a
    16-CTA cluster, K6 its whole factor (about 0.98 MB over 16 CTAs) in
    the one cluster of one right-hand side."""
    b, bw, nb = CASE118
    f = bf.fused_factorize_plan(b, bw, nb, torch.float32, H100)
    assert f == bf.FactorizePlan(clusters=16, resident=True,
                                 smem=(9408 + 6 * 64 * 64) * 4)
    s = bf.fused_solve_plan(b, bw, nb, 1, torch.float32, H100)
    assert s == bf.SolvePlan(clusters=16, cols=1, rows=24, stages=20,
                             resident=True,
                             smem=256 + (20 * 24 * 64 + 8 * 64 + 4 * 4) * 4)
    # in float64 neither fits
    assert not bf.fused_factorize_plan(b, bw, nb, torch.float64,
                                       H100).resident
    assert not bf.fused_solve_plan(b, bw, nb, 1, torch.float64,
                                   H100).resident


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bw,nb", [(2, 11), (4, 8), (4, 10)])
def test_b256_geometries_stream(bw, nb, dtype):
    f = bf.fused_factorize_plan(256, bw, nb, dtype, H100)
    assert f.clusters == 16 and not f.resident
    for k in WIDTHS:
        assert not bf.fused_solve_plan(256, bw, nb, k, dtype, H100).resident


def test_solve_tiles_take_clusters_that_are_resident_together():
    f32 = torch.float32
    # one column a cluster while the clusters keep 8 CTAs or more
    assert bf.fused_solve_plan(64, 5, 10, 1, f32, H100)[:2] == (16, 1)
    assert bf.fused_solve_plan(64, 5, 10, 8, f32, H100)[:2] == (8, 1)
    assert bf.fused_solve_plan(64, 5, 10, 16, f32, H100)[:2] == (8, 2)
    # 130 columns: 17 tiles of 8 on clusters of 4 (the card keeps 30);
    # 256: 32 tiles of 8 on clusters of 2 (66)
    assert bf.fused_solve_plan(64, 5, 10, 130, f32, H100)[:2] == (4, 8)
    assert bf.fused_solve_plan(64, 5, 10, 256, f32, H100).clusters == 2
    assert bf.fused_solve_plan(64, 5, 10, 8, torch.float32,
                               NO_16).clusters == 8
    # 16-byte column slices: b = 32 in float32 takes at most 8 CTAs
    assert bf.fused_solve_plan(32, 2, 9, 8, torch.float32, H100).clusters == 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_impossible_requests_raise(dtype):
    with pytest.raises(ValueError):
        bf.fused_factorize_plan(48, 2, 10, dtype, H100)
    with pytest.raises(ValueError):
        bf.fused_factorize_plan(64, 0, 10, dtype, H100)
    with pytest.raises(ValueError):
        bf.fused_solve_plan(512, 2, 10, 8, dtype, H100)
    # a window of x that no tile width leaves room for
    with pytest.raises(ValueError, match="no K6 plan fits"):
        bf.fused_solve_plan(256, 500, 4, 8, dtype, H100)
