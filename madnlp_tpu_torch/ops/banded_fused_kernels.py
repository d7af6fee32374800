"""The whole-band Hopper kernels of the banded LDLᵀ (K5, K6) and their
wrappers — the counterpart of ``madnlp_tpu/ops/pallas_banded.py``.

* K5 :func:`banded_fused_factorize_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded.py:_factorize_call`` (body
  ``_factorize_kernel``): the whole block-banded LDLᵀ + L_jj⁻¹ in **one**
  kernel launch over one thread-block cluster, the block-column loop
  inside the kernel;
* K6 :func:`banded_fused_solve_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded.py:_solve_call`` (body ``_solve_kernel``):
  forward sweep, z/d on the real rows and backward sweep in one launch,
  one cluster per tile of right-hand-side columns;
* :func:`banded_fused_factorize_reference_cuda` and
  :func:`banded_fused_solve_reference_cuda` launch the one-CTA kernels
  K5 and K6 replaced, their card-side witnesses, which they equal bit for
  bit (no path reaches them but the checks that hold the two together).

All are CUDA C++ for ``sm_90a`` in ``csrc/banded_fused.cu`` (K5 shares
K1's diagonal step, ``csrc/banded_diag.cuh``; K6 the cluster helpers of
K2, ``csrc/banded_cluster.cuh``), compiled by ``nvcc`` into
``build/kernels/`` at first use and loaded with ``ctypes``; nothing is
built or imported until a CUDA tensor arrives.  The launch plans
(:func:`fused_factorize_plan`, :func:`fused_solve_plan`) are pure Python:
the cluster size, and whether the factor stays resident in the cluster's
shared memory or streams through it.

:func:`banded_fused_factorize` and :func:`banded_fused_solve` mirror
``pallas_banded_factorize`` and ``pallas_banded_solve``: the same
:class:`BandedFactor`, the same padding of the right-hand side (rows to
``nbp·b``, width ``k`` to ``8·⌈k/8⌉`` below 128 and ``128·⌈k/128⌉`` from 128
up, ``d`` zero-padded beyond ``nb·b``).  For a tensor on the card they
launch the kernels (or raise); for a tensor on the CPU they run
:func:`banded_fused_factorize_plain` / :func:`banded_fused_solve_plain`,
which are the port's plain banded factor and solve (:mod:`.banded`): the
TPU kernel computes the same function in the same panel-blocked order
(tests/test_torch_fused_banded.py holds them against it).

As in the JAX package, no solve path calls these: the KKT system factors
with K1/K2 (:mod:`.banded_kernels`).  The JAX package's ``fits_vmem``
(which bands fit the TPU's scoped VMEM) has its counterpart in the plans'
``resident``: where a band fits the cluster's shared memory it is loaded
once and written back once.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import torch

from . import banded as plain
from .banded import BandedFactor, BandStructure
from .banded_kernels import (
    _SUFFIX,
    BUILD_DIR,
    CLUSTER_SIZES,
    SMEM_LIMIT,
    SUPPORTED_BLOCKS,
    _check,
    _route,
    compile_library,
    max_clusters,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "banded_fused.cu")
LIBRARY = os.path.join(BUILD_DIR, "libbanded_fused.so")

_lib = None


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile ``csrc/banded_fused.cu`` (see
    :func:`.banded_kernels.compile_library`)."""
    return compile_library(SOURCE, LIBRARY, force, ptxas_info)


# csrc/banded_fused.cu's constants: the threads of the witness K6 (whose
# FSOLVE_THREADS / b strided chains per column K6 keeps), the stages of
# K6's ring where it streams and where the factor is resident, K5's
# product staging (two 32-deep slices of each operand, 64 rows at a pitch
# of 68) and the diagonal step's panel (banded_diag.cuh)
FSOLVE_THREADS = 256
MAX_STAGES = 8
# K6's plan takes the narrowest column tile whose clusters get this many
# CTAs or more (tools/fused_probe.py)
MIN_SOLVE_CLUSTER = 8
MAX_RESIDENT_STAGES = 64
STAGE_ELEMS = 2 * 2 * 32 * (64 + 4)
PANEL = 32


def load():
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        sigs = {"banded_fused_factorize": [vp] * 4 + [ci] * 5 + [vp],
                "banded_fused_factorize_reference": [vp] * 4 + [ci] * 3 + [vp],
                "banded_fused_solve": [vp] * 4 + [ci] * 9 + [vp],
                "banded_fused_solve_reference": [vp] * 4 + [ci] * 4 + [vp]}
        for name, args in sigs.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = args
                fn.restype = ci
        _lib = lib
    return _lib


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


class FactorizePlan(NamedTuple):
    """K5's launch plan: one cluster of ``clusters`` CTAs; ``resident``:
    the off-diagonal blocks and the panel live in its shared memory;
    ``smem`` bytes of shared memory per CTA."""
    clusters: int
    resident: bool
    smem: int


def fused_factorize_plan(b: int, bw: int, nb: int, dtype,
                         max_clusters) -> FactorizePlan:
    """K5's launch plan for a band of ``nb`` block columns of block ``b``
    and bandwidth ``bw``; ``max_clusters`` maps a cluster size C to the
    clusters of C CTAs the card keeps resident at once
    (:func:`.banded_kernels.max_clusters`).

    C is the largest size in :data:`CLUSTER_SIZES` the card can place
    (one cluster) that is no larger than the trailing update's tiles plus
    the CTA that factors the next diagonal block.  The band is resident
    where its off-diagonal blocks (``(nb+bw)·bw``, dealt round robin),
    ``bw`` panel blocks and the scratch (the diagonal step's or the
    products' staging, whichever is larger) fit each CTA's shared memory;
    elsewhere it stays in global memory.  Raises ``ValueError`` for a
    geometry K5 does not take."""
    if b not in SUPPORTED_BLOCKS or bw < 1 or nb < 1:
        raise ValueError(f"no K5 plan for b={b}, bw={bw}, nb={nb}")
    item = _itemsize(dtype)
    tiles = max(1, b // 64) ** 2
    cap = bw * (bw + 1) // 2 * tiles + 1
    diag = PANEL * (PANEL + 1) + PANEL * PANEL + PANEL * (PANEL + 4) + PANEL \
        + 3 * PANEL * b
    scratch = max(diag, STAGE_ELEMS)
    for C in CLUSTER_SIZES:
        if C > cap or (C > 1 and max_clusters.get(C, 0) < 1):
            continue
        slots = -(-(nb + bw) * bw // C) + -(-bw // C)
        smem = (scratch + slots * b * b) * item
        if smem <= SMEM_LIMIT:
            return FactorizePlan(C, True, smem)
        return FactorizePlan(C, False, scratch * item)
    raise ValueError(f"no K5 plan for b={b}, bw={bw}, nb={nb}")


class SolvePlan(NamedTuple):
    """K6's launch plan: one cluster of ``clusters`` CTAs per tile of
    ``cols`` right-hand-side columns; ``rows`` forward rows (of b
    elements) per shared-memory stage, ``stages`` stages; ``resident``:
    every stage holds its own chunk of the factor (all copied in before
    the forward sweep); ``smem`` bytes of shared memory per CTA."""
    clusters: int
    cols: int
    rows: int
    stages: int
    resident: bool
    smem: int


def _barrier_bytes(stages: int) -> int:
    return -(-(3 + stages) * 8 // 128) * 128


def solve_plan_with(b: int, bw: int, nb: int, k: int, cols: int, dtype,
                    max_clusters, min_clusters: int = 1):
    """K6's plan for ``k`` columns in tiles of ``cols`` (see
    :func:`fused_solve_plan`) on clusters of at least ``min_clusters``
    CTAs, or None where none fits."""
    item = _itemsize(dtype)
    slices = FSOLVE_THREADS // b
    tiles = -(-k // cols)
    for C in CLUSTER_SIZES:
        nr = b // C
        if C < min_clusters:
            break
        if b % C or nr * item % 16:
            continue
        if C > 1 and max_clusters.get(C, 0) < tiles:
            continue
        fixed = ((bw + 3) * b * cols + nr * slices * cols) * item
        frows = (bw + 1) * nr
        stages = 2 * nb
        if stages <= MAX_RESIDENT_STAGES:
            smem = _barrier_bytes(stages) + fixed + stages * frows * b * item
            if smem <= SMEM_LIMIT:
                return SolvePlan(C, cols, frows, stages, True, smem)
        room = SMEM_LIMIT - _barrier_bytes(MAX_STAGES) - fixed
        rows = min(frows, room // (2 * b * item))
        if rows < 1:
            continue
        # whole TMA boxes of up to 16 rows
        box = 1 << (min(nr, rows, 16).bit_length() - 1)
        rows -= rows % box
        stages = min(MAX_STAGES, room // (rows * b * item))
        return SolvePlan(C, cols, rows, stages, False,
                         _barrier_bytes(stages) + fixed
                         + stages * rows * b * item)
    return None


def fused_solve_plan(b: int, bw: int, nb: int, k: int, dtype,
                     max_clusters) -> SolvePlan:
    """K6's launch plan for ``k`` right-hand-side columns (of the padded
    width the kernel gets; the columns past them are zero padding, left
    as they are), block ``b``, bandwidth ``bw``, ``nb`` block columns;
    ``max_clusters`` as for :func:`fused_factorize_plan`.

    The columns are cut into tiles of ``cols`` columns, one cluster each.
    For a width of 1, 2, 4 and 8 in turn, the ⌈k/cols⌉ clusters take the
    largest size in :data:`CLUSTER_SIZES` that divides b into column
    slices of whole 16-byte vectors and keeps them all resident in one
    wave; the first width that gets clusters of at least
    :data:`MIN_SOLVE_CLUSTER` CTAs is taken (each column a cluster adds to
    every step of the sweeps' chain), else the widest that fits at all.
    The factor is resident where a CTA's rows and columns of every block
    column, one stage each, fit its shared memory; elsewhere it streams
    through a ring of stages as in K2's :func:`.banded_kernels.solve_plan`.
    Raises ``ValueError`` where no plan fits."""
    if b not in SUPPORTED_BLOCKS or bw < 1 or nb < 1 or k < 1:
        raise ValueError(f"no K6 plan for b={b}, bw={bw}, nb={nb}, k={k}")
    for cols in (1, 2, 4, 8):
        plan = solve_plan_with(b, bw, nb, k, cols, dtype, max_clusters,
                               MIN_SOLVE_CLUSTER)
        if plan is not None:
            return plan
    for cols in (8, 4, 2, 1):
        plan = solve_plan_with(b, bw, nb, k, cols, dtype, max_clusters)
        if plan is not None:
            return plan
    raise ValueError(f"no K6 plan fits b={b}, bw={bw}, k={k}, {dtype} in "
                     f"{SMEM_LIMIT} bytes of shared memory")


_plans = {}


def factorize_plan_for(band, nb: int, b: int, bw: int) -> FactorizePlan:
    """The plan K5 launches for this band (kept per geometry, dtype and
    device)."""
    key = ("K5", nb, b, bw, band.dtype, band.device)
    if key not in _plans:
        _plans[key] = fused_factorize_plan(
            b, bw, nb, band.dtype, max_clusters(band.dtype, band.device))
    return _plans[key]


def solve_plan_for(band, k: int) -> SolvePlan:
    """The plan K6 launches for ``k`` columns (kept per geometry, k, dtype
    and device)."""
    nbp, bw1, b, _ = band.shape
    key = ("K6", nbp, bw1, b, k, band.dtype, band.device)
    if key not in _plans:
        _plans[key] = fused_solve_plan(
            b, bw1 - 1, nbp - bw1 + 1, k, band.dtype,
            max_clusters(band.dtype, band.device))
    return _plans[key]


def _check_factorize(name, band, invL, d, nb, b, bw):
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    if not band.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    nbp = nb + bw
    _check("band", band, (nbp, bw + 1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    if d.numel() < nb * b:
        raise ValueError(f"d has {d.numel()} entries, needs {nb * b}")
    _check("d", d, (d.numel(),), band.dtype, band.device)


def _launch(name, *args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        return getattr(load(), name)(*args, stream)


def banded_fused_factorize_cuda(band, invL, d, nb: int, b: int, bw: int):
    """K5: factor block columns 0..nb-1 of ``band (nb+bw, bw+1, b, b)`` in
    place, in one kernel launch over one cluster (the plan of
    :func:`fused_factorize_plan`); writes ``invL (nb+bw, b, b)`` and
    ``d (≥ nb·b,)`` for the real columns and leaves them untouched in the
    overhang.  float32 or float64."""
    _check_factorize("banded_fused_factorize_cuda", band, invL, d, nb, b, bw)
    plan = factorize_plan_for(band, nb, b, bw)
    xbuf = torch.empty((bw * b, b), dtype=band.dtype, device=band.device)
    err = _launch("banded_fused_factorize_" + _SUFFIX[band.dtype],
                  band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                  xbuf.data_ptr(), nb, b, bw, plan.clusters,
                  int(plan.resident), device=band.device)
    banded_fused_factorize_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_factorize_cuda: CUDA error {err}")
    return band, invL, d


banded_fused_factorize_cuda.launches = 0


def banded_fused_factorize_reference_cuda(band, invL, d, nb: int, b: int,
                                          bw: int):
    """The witness of K5: the one-CTA kernel K5 replaced (the
    scalar diagonal step), the same operands and outputs."""
    _check_factorize("banded_fused_factorize_reference_cuda", band, invL, d,
                     nb, b, bw)
    xbuf = torch.empty((bw * b, b), dtype=band.dtype, device=band.device)
    err = _launch("banded_fused_factorize_reference_" + _SUFFIX[band.dtype],
                  band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                  xbuf.data_ptr(), nb, b, bw, device=band.device)
    banded_fused_factorize_reference_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_factorize_reference_cuda: CUDA "
                           f"error {err}")
    return band, invL, d


banded_fused_factorize_reference_cuda.launches = 0


def _check_solve(name, band, invL, d, x):
    if not band.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    if band.ndim != 4 or x.ndim != 2:
        raise ValueError("band must be (nb+bw, bw+1, b, b) and x "
                         "((nb+bw)·b, kp)")
    nbp, bw1, b, _ = band.shape
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    _check("band", band, (nbp, bw1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    _check("d", d, (nbp * b,), band.dtype, band.device)
    kp = x.shape[1]
    if kp % 8:
        raise ValueError(f"x has {kp} columns, not a multiple of 8")
    _check("x", x, (nbp * b, kp), band.dtype, band.device)
    return nbp - bw1 + 1, b, bw1 - 1, kp


def banded_fused_solve_cuda(band, invL, d, x, k: int | None = None):
    """K6: solve in place on ``x ((nb+bw)·b, kp)`` (permuted, zero padded,
    ``kp`` a multiple of 8) with the factor from
    :func:`banded_fused_factorize_cuda`, in one launch (the plan of
    :func:`fused_solve_plan`); ``d`` holds ``(nb+bw)·b`` pivots of which
    the first ``nb·b`` are read.  ``k`` (all ``kp`` by default): the
    columns to solve; the columns of the tiles past them are left as they
    are, so zero padding stays zero, which is what the solve (and the
    witness) makes of a zero column.  The overhang rows of the result are
    don't-care (they hold what the witness leaves there)."""
    nb, b, bw, kp = _check_solve("banded_fused_solve_cuda", band, invL, d, x)
    k = kp if k is None else k
    if not 1 <= k <= kp:
        raise ValueError(f"k = {k} columns of {kp}")
    plan = solve_plan_for(band, k)
    err = _launch("banded_fused_solve_" + _SUFFIX[band.dtype],
                  band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                  x.data_ptr(), nb, b, bw, kp, k, plan.cols, plan.clusters,
                  plan.rows, plan.stages, device=band.device)
    banded_fused_solve_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_solve_cuda: CUDA error {err}")
    return x


banded_fused_solve_cuda.launches = 0


def banded_fused_solve_reference_cuda(band, invL, d, x):
    """The witness of K6: the kernel K6 replaced (one CTA per tile
    of 8 columns), the same operands."""
    nb, b, bw, kp = _check_solve("banded_fused_solve_reference_cuda", band,
                                 invL, d, x)
    err = _launch("banded_fused_solve_reference_" + _SUFFIX[band.dtype],
                  band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                  x.data_ptr(), nb, b, bw, kp, device=band.device)
    banded_fused_solve_reference_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_solve_reference_cuda: CUDA error "
                           f"{err}")
    return x


banded_fused_solve_reference_cuda.launches = 0

KERNELS = (banded_fused_factorize_cuda, banded_fused_solve_cuda)
WITNESSES = (banded_fused_factorize_reference_cuda,
             banded_fused_solve_reference_cuda)


def reset_counts():
    for k in KERNELS + WITNESSES:
        k.launches = 0


def counts() -> dict:
    """Launches of K5 and K6 since the last :func:`reset_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


def witness_counts() -> dict:
    """Launches of the witnesses since the last :func:`reset_counts`."""
    return {k.__name__: k.launches for k in WITNESSES}


# -- plain versions and the public functions ----------------------------------


def banded_fused_factorize_plain(struct: BandStructure,
                                 band: torch.Tensor) -> BandedFactor:
    """The plain version of K5: the port's plain block-banded LDLᵀ
    (:func:`.banded.banded_factorize`), which runs the TPU kernel's
    panel-blocked order; ``invL`` zero and ``d`` one in the overhang."""
    return plain.banded_factorize(struct, band)


def pad_width(k: int) -> int:
    """Right-hand-side width as the TPU kernel pads it: 8·⌈k/8⌉ below 128,
    128·⌈k/128⌉ from 128 up."""
    return max(8, -(-k // 8) * 8) if k < 128 else -(-k // 128) * 128


def _padded(struct: BandStructure, f: BandedFactor, rhs: torch.Tensor):
    """(work (nbp·b, kp), d (nbp·b,)): the zero-padded right-hand side and
    the pivots zero-padded beyond nb·b, as ``pallas_banded_solve`` builds
    them."""
    r = rhs[:, None] if rhs.ndim == 1 else rhs
    work = r.new_zeros((struct.nbp * struct.b, pad_width(r.shape[1])))
    work[: struct.N, : r.shape[1]] = r
    d = f.d.new_zeros((struct.nbp * struct.b,))
    d[: struct.nb * struct.b] = f.d
    return work, d


def _unpadded(struct: BandStructure, work: torch.Tensor, rhs: torch.Tensor):
    """The real rows and columns of a padded solution, shaped as ``rhs``."""
    if rhs.ndim == 1:
        return work[: struct.N, 0]
    return work[: struct.N, : rhs.shape[1]]


def banded_fused_solve_plain(struct: BandStructure, f: BandedFactor,
                             rhs: torch.Tensor) -> torch.Tensor:
    """The plain version of K6 on the same padded right-hand side: the
    port's plain banded solve (:func:`.banded.solve_padded`), the TPU
    kernel's sweeps in the same order.  ``rhs``: (N,) or (N, k)."""
    work, d = _padded(struct, f, rhs)
    return _unpadded(struct, plain.solve_padded(f.band, f.invL, d, work), rhs)


def banded_fused_factorize(struct: BandStructure,
                           band: torch.Tensor) -> BandedFactor:
    """Counterpart of ``pallas_banded_factorize``: block-banded LDLᵀ of an
    assembled band.  On the card the band is factored in place (consumed)
    by one K5 launch; on the CPU the input is left as it was."""
    if _route(band) == "plain":
        return banded_fused_factorize_plain(struct, band)
    b, nb, nbp = struct.b, struct.nb, struct.nbp
    band = band.contiguous()
    invL = torch.zeros((nbp, b, b), dtype=band.dtype, device=band.device)
    d = torch.ones((nbp * b,), dtype=band.dtype, device=band.device)
    banded_fused_factorize_cuda(band, invL, d, nb, b, struct.bw)
    return BandedFactor(band=band, invL=invL, d=d[: nb * b])


def banded_fused_solve(struct: BandStructure, f: BandedFactor,
                       rhs: torch.Tensor) -> torch.Tensor:
    """Counterpart of ``pallas_banded_solve``: solve in PERMUTED
    coordinates; ``rhs`` (N,) or (N, k)."""
    if _route(rhs) == "plain":
        return banded_fused_solve_plain(struct, f, rhs)
    work, d = _padded(struct, f, rhs)
    k = 1 if rhs.ndim == 1 else rhs.shape[1]
    return _unpadded(struct,
                     banded_fused_solve_cuda(f.band, f.invL, d, work, k), rhs)
