"""The launch plan of the cluster solve (K2 and K4,
``madnlp_tpu_torch/ops/banded_kernels.py:solve_plan``), pure Python: the
plan must fit the shared memory a CTA may use, divide the block into
16-byte column slices, keep every lane's cluster resident in one wave, and
raise where no plan fits.

``H100`` is the residency an NVIDIA H100 80GB HBM3 reports for the
kernel at one CTA per SM (``max_clusters``, by
``cudaOccupancyMaxActiveClusters``); ``NO_16`` a card that keeps no cluster
of 16.
"""

import itertools

import pytest
import torch

from madnlp_tpu_torch.ops import banded_kernels as bk

torch.set_num_threads(1)

H100 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
NO_16 = {1: 132, 2: 66, 4: 30, 8: 15, 16: 0}


def _smem(plan, b, bw, k, item):
    """Shared memory of the plan, recomputed from csrc/banded_ldlt.cu's
    layout: its mbarriers, the stages, the x window and r (bw+1 blocks), z
    (two buffers), the partial sums."""
    nr = b // plan.clusters
    slices = bk.SOLVE_THREADS // b
    return bk.BARRIER_BYTES + (plan.stages * plan.rows * b
                               + (bw + 3) * b * k + nr * slices * k) * item


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cap", [H100, NO_16])
def test_every_supported_geometry_has_a_plan_that_fits(dtype, cap):
    item = torch.empty((), dtype=dtype).element_size()
    for b, bw, k, lanes in itertools.product(bk.SUPPORTED_BLOCKS,
                                             range(1, 8), (1, 8), (1, 3, 16)):
        plan = bk.solve_plan(lanes, b, bw, k, dtype, cap)
        C = plan.clusters
        assert plan.smem == _smem(plan, b, bw, k, item) <= bk.SMEM_LIMIT
        assert b % C == 0 and (bw * b) % C == 0
        assert (b // C) * item % 16 == 0
        assert C == 1 or lanes <= cap[C]
        assert 1 <= plan.rows <= (bw + 1) * b // C
        # whole TMA boxes: a power of two up to 16 and b/C divides the rows
        box = 1 << (min(b // C, plan.rows, 16).bit_length() - 1)
        assert plan.rows % box == 0
        assert 2 <= plan.stages <= bk.MAX_STAGES


def test_the_largest_resident_cluster_is_taken():
    f32 = torch.float32
    assert bk.solve_plan(1, 256, 2, 1, f32, H100).clusters == 16
    assert bk.solve_plan(1, 256, 2, 1, f32, NO_16).clusters == 8
    # the batch's 16 lanes: 15 clusters of 8 fit the card at once, 30 of 4
    assert bk.solve_plan(15, 256, 2, 1, f32, H100).clusters == 8
    assert bk.solve_plan(16, 256, 2, 1, f32, H100).clusters == 4
    assert bk.solve_plan(31, 256, 2, 1, f32, H100).clusters == 2
    assert bk.solve_plan(200, 256, 2, 1, f32, H100).clusters == 1
    # 16-byte column slices: b = 32 in float32 takes at most 8 CTAs
    assert bk.solve_plan(1, 32, 2, 1, f32, H100).clusters == 8
    assert bk.solve_plan(1, 32, 2, 1, torch.float64, H100).clusters == 16


def test_the_flagship_streams_whole_block_columns():
    """At the flagship's geometry a stage holds a CTA's whole share of a
    block column (48 rows of 256) and four stages fit; at the ring's in
    float64 a block column (160 KB) is cut into two chunks."""
    plan = bk.solve_plan(1, 256, 2, 1, torch.float32, H100)
    assert plan == bk.SolvePlan(clusters=16, rows=48, stages=4,
                                smem=128 + 4 * 48 * 256 * 4
                                + (5 * 256 + 64) * 4)
    ring = bk.solve_plan(1, 256, 4, 1, torch.float64, H100)
    assert ring == bk.SolvePlan(clusters=16, rows=48, stages=2,
                                smem=128 + 2 * 48 * 256 * 8
                                + (7 * 256 + 64) * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_no_plan_raises(dtype):
    with pytest.raises(ValueError, match="no cluster-solve plan"):
        bk.solve_plan(1, 256, 2, 130, dtype, H100)
    with pytest.raises(ValueError):
        bk.solve_plan(16, 256, 7, 32, dtype, H100)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_batched_smw_solve_has_a_plan(dtype):
    """K4 on the 2p = 12 columns of compact L-BFGS's SMW payload over the
    nb600 batch's 16 lanes (b = 256, bw = 2): one wave of clusters of 4,
    the whole block in each stage's rows where they fit."""
    item = torch.empty((), dtype=dtype).element_size()
    plan = bk.solve_plan(16, 256, 2, 12, dtype, H100)
    assert plan.clusters == 4
    assert plan.smem == _smem(plan, 256, 2, 12, item) <= bk.SMEM_LIMIT
    assert plan.stages >= 2 and plan.rows >= 16
