"""The Hopper kernels of the banded LDLᵀ and their wrappers.

* K1 :func:`banded_factorize_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded_stream.py:_stream_factorize_kernel``;
* K2 :func:`banded_solve_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded_stream.py:_stream_solve_kernel``;
* K3 :func:`banded_factorize_batched_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded_stream.py:_stream_factorize_call_batched``;
* K4 :func:`banded_solve_batched_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded_stream.py:_stream_solve_call_batched``;
* :func:`banded_diag_step_cuda` launches the diagonal step of K1 and K3
  alone (``pallas_banded.py:_ldlt_with_inverse``), for timing it and for
  holding it bit for bit against the scalar routine K5's witness keeps;
* :func:`banded_solve_reference_cuda` launches the one-CTA-per-lane solve
  that K2 and K4 replaced, the card-side witness they equal bit for bit
  (no solve path reaches it).

All are CUDA C++ for ``sm_90a`` in ``csrc/banded_ldlt.cu`` (K3 runs K1's
kernels with a lane index, K2 and K4 are one kernel over one thread-block
cluster per lane, launched with the plan of :func:`solve_plan`), compiled
by ``nvcc`` into ``build/kernels/`` at first use and loaded with
``ctypes``.  Each wrapper checks device, dtype, shape and contiguity,
allocates the scratch it needs with ``torch.empty``, launches on the
current stream, raises if the C entry returns a CUDA error, and counts its
launches in its ``launches`` attribute.

:func:`factorize` / :func:`solve` (one system) and
:func:`factorize_batched` / :func:`solve_batched` (a batch of lanes under
an ``active`` mask) are what the KKT system calls: for a tensor on the
card they launch the kernels (or raise), for a tensor on the CPU they run
the plain versions of :mod:`.banded`.  Nothing here is imported or built
until a CUDA tensor arrives.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from . import banded as plain
from .banded import BandedFactor, BandStructure

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "banded_ldlt.cu")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
LIBRARY = os.path.join(BUILD_DIR, "libbanded_ldlt.so")
SUPPORTED_BLOCKS = (32, 64, 128, 256)

# The cluster solve (K2, K4): csrc/banded_ldlt.cu's SMEM_LIMIT (the shared
# memory a CTA may use on the H100), BARRIER_BYTES (its mbarriers),
# MAX_STAGES, and the cluster sizes it takes, largest first.  Its backward
# sweep keeps the reference's strided partial sums: SOLVE_THREADS / b
# chains per column.
SMEM_LIMIT = 232448
BARRIER_BYTES = 128
MAX_STAGES = 8
CLUSTER_SIZES = (16, 8, 4, 2, 1)
SOLVE_THREADS = 1024

_lib = None


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the banded CUDA kernels cannot be built")


def compile_library(source: str, library: str, force: bool = False,
                    ptxas_info: bool = False) -> str:
    """Compile the CUDA ``source`` into the shared ``library`` (sm_90a)
    unless an up-to-date one exists; returns its path.  The library is
    written under a temporary name and renamed, so concurrent builds never
    load a partial file.  ``ptxas_info`` prints each kernel's registers,
    shared memory and spills as ``nvcc -Xptxas -v`` reports them."""
    # the sources include headers of their directory (csrc/*.cuh)
    deps = [source] + glob.glob(os.path.join(os.path.dirname(source), "*.cuh"))
    fresh = (os.path.exists(library) and os.path.getmtime(library)
             >= max(os.path.getmtime(p) for p in deps))
    if fresh and not force:
        return library
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, source]
    if ptxas_info:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if ptxas_info:
        print(proc.stderr, flush=True)
    os.replace(tmp, library)
    return library


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile ``csrc/banded_ldlt.cu`` (see :func:`compile_library`)."""
    return compile_library(SOURCE, LIBRARY, force, ptxas_info)


def load():
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("banded_factorize_f32", "banded_factorize_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_solve_cluster_f32", "banded_solve_cluster_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp] + [ci] * 8 + [vp]
            fn.restype = ci
        for name in ("banded_solve_reference_f32",
                     "banded_solve_reference_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_solve_max_clusters_f32",
                     "banded_solve_max_clusters_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ci, ctypes.POINTER(ci)]
            fn.restype = ci
        for name in ("banded_factorize_batched_f32",
                     "banded_factorize_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_diag_step_f32", "banded_diag_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ci, ci, ci, vp]
            fn.restype = ci
        _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def banded_factorize_cuda(band, invL, d, nb: int, b: int, bw: int):
    """K1: factor block columns 0..nb-1 of ``band (nb+bw, bw+1, b, b)`` in
    place; writes ``invL (nb+bw, b, b)`` and ``d (≥ nb·b,)`` for the real
    columns and leaves the overhang untouched.  float32 or float64."""
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    if not band.is_cuda:
        raise ValueError("banded_factorize_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    nbp = nb + bw
    _check("band", band, (nbp, bw + 1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    if d.numel() < nb * b:
        raise ValueError(f"d has {d.numel()} entries, needs {nb * b}")
    _check("d", d, (d.numel(),), band.dtype, band.device)
    xbuf = torch.empty((bw * b, b), dtype=band.dtype, device=band.device)
    fn = getattr(load(), "banded_factorize_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 xbuf.data_ptr(), nb, b, bw, stream)
    banded_factorize_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_factorize_cuda: CUDA error {err}")
    return band, invL, d


banded_factorize_cuda.launches = 0


class SolvePlan(NamedTuple):
    """The launch plan of the cluster solve: ``clusters`` CTAs per lane,
    ``rows`` forward rows (of b elements) per shared-memory stage, a ring
    of ``stages`` stages, ``smem`` bytes of shared memory per CTA."""
    clusters: int
    rows: int
    stages: int
    smem: int


def solve_plan(lanes: int, b: int, bw: int, k: int, dtype,
               max_clusters) -> SolvePlan:
    """The cluster solve's launch plan for ``lanes`` systems of block
    ``b`` and bandwidth ``bw`` with ``k`` right-hand sides; ``max_clusters``
    maps a cluster size C to the clusters of C CTAs the card keeps resident
    at once (:func:`max_clusters`).

    C is the largest size in :data:`CLUSTER_SIZES` that divides b into
    column slices of whole 16-byte vectors and leaves all lanes' clusters
    resident in one wave (C = 1 always qualifies); a stage holds up to the
    (bw+1)·b/C rows of b elements a CTA reads of one block column (all of
    them where two stages fit), in whole TMA boxes (a multiple of the
    largest power of two up to 16 and b/C that it holds), and the ring as
    many stages as fit, at least two and at most :data:`MAX_STAGES`.
    Raises ``ValueError`` where no plan fits the shared memory (a k too
    large)."""
    item = torch.finfo(dtype).bits // 8
    slices = SOLVE_THREADS // b
    for C in CLUSTER_SIZES:
        nr = b // C
        if b % C or nr * item % 16:
            continue
        if C > 1 and max_clusters.get(C, 0) < lanes:
            continue
        fixed = BARRIER_BYTES + ((bw + 3) * b * k + nr * slices * k) * item
        room = SMEM_LIMIT - fixed
        rows = min((bw + 1) * nr, room // (2 * b * item))
        if rows < 1:
            continue
        # whole TMA boxes of up to 16 rows
        box = 1 << (min(nr, rows, 16).bit_length() - 1)
        rows -= rows % box
        stages = min(MAX_STAGES, room // (rows * b * item))
        return SolvePlan(C, rows, stages, fixed + stages * rows * b * item)
    raise ValueError(f"no cluster-solve plan fits {k} right-hand sides at "
                     f"b={b}, bw={bw}, {dtype} in {SMEM_LIMIT} bytes of "
                     f"shared memory")


_max_clusters = {}


def max_clusters(dtype, device=None) -> dict:
    """{C: clusters of C CTAs of the cluster solve the card keeps resident
    at once}, from ``cudaOccupancyMaxActiveClusters`` at one CTA per SM;
    queried once per device and dtype."""
    device = torch.device("cuda") if device is None else torch.device(device)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, dtype)
    if key not in _max_clusters:
        fn = getattr(load(), "banded_solve_max_clusters_" + _SUFFIX[dtype])
        out = {}
        with torch.cuda.device(index):
            for C in CLUSTER_SIZES:
                n = ctypes.c_int(0)
                err = fn(C, ctypes.byref(n))
                if err:
                    raise RuntimeError(f"cudaOccupancyMaxActiveClusters "
                                       f"(C={C}): CUDA error {err}")
                out[C] = n.value
        _max_clusters[key] = out
    return _max_clusters[key]


def _check_solve(name, band, invL, d, rhs, lanes):
    """Shapes of a solve's operands: ``band (lanes?, nb+bw, bw+1, b, b)``,
    ``invL (lanes?, nb+bw, b, b)``, ``d`` (lanes, ≥ nb·b) or, for one
    system, a vector of ≥ nb·b pivots, ``rhs (lanes?, (nb+bw)·b, k)``;
    returns (nb, b, bw, k)."""
    if not band.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    lead = () if lanes is None else (lanes,)
    if band.ndim != len(lead) + 4 or rhs.ndim != len(lead) + 2:
        raise ValueError("band must be (nb+bw, bw+1, b, b) and rhs "
                         "((nb+bw)·b, k), with a leading lane axis for "
                         "a batch")
    nbp, bw1, b, _ = band.shape[len(lead):]
    bw = bw1 - 1
    nb = nbp - bw
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    k = rhs.shape[-1]
    _check("band", band, lead + (nbp, bw1, b, b), band.dtype, band.device)
    _check("invL", invL, lead + (nbp, b, b), band.dtype, band.device)
    if lanes is None:
        if d.numel() < nb * b or not d.is_contiguous() \
                or d.dtype != band.dtype or d.device != band.device:
            raise ValueError("d must be a contiguous vector of ≥ nb·b "
                             "pivots of the band's dtype and device")
    else:
        _check("d", d, (lanes, nb * b), band.dtype, band.device)
    _check("rhs", rhs, lead + (nbp * b, k), band.dtype, band.device)
    return nb, b, bw, k


_plans = {}


def plan_for(band, rhs) -> SolvePlan:
    """The plan K2 (``band`` 4-D) or K4 (5-D, a leading lane axis) launches
    for this ``rhs`` (kept per shape, dtype and device: the solver asks for
    the same few on every call)."""
    key = (tuple(band.shape), rhs.shape[-1], band.dtype, band.device)
    if key not in _plans:
        lanes = band.shape[0] if band.ndim == 5 else 1
        b, bw = band.shape[-1], band.shape[-3] - 1
        _plans[key] = solve_plan(lanes, b, bw, rhs.shape[-1], band.dtype,
                                 max_clusters(band.dtype, band.device))
    return _plans[key]


def _launch_cluster_solve(band, invL, d, rhs, mask, lanes, nb, b, bw, k):
    plan = plan_for(band, rhs)
    fn = getattr(load(), "banded_solve_cluster_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                  rhs.data_ptr(), None if mask is None else mask.data_ptr(),
                  lanes, nb, b, bw, k, plan.clusters, plan.rows, plan.stages,
                  stream)


def banded_solve_cuda(band, invL, d, rhs):
    """K2: solve in place on ``rhs ((nb+bw)·b, k)`` (permuted, zero
    padded) with the factor from :func:`banded_factorize_cuda`, on one
    cluster of :func:`solve_plan`'s size; the padding rows of the result
    are zero.  Raises ``ValueError`` for a k no plan fits."""
    nb, b, bw, k = _check_solve("banded_solve_cuda", band, invL, d, rhs, None)
    err = _launch_cluster_solve(band, invL, d, rhs, None, 1, nb, b, bw, k)
    banded_solve_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_solve_cuda: CUDA error {err}")
    return rhs


banded_solve_cuda.launches = 0


def _active_mask(active, lanes: int, device) -> torch.Tensor:
    """The lane mask (numpy bool (B,)) as the kernels read it: int32 (B,)
    on the card; a mask already in that form is taken as it is."""
    if isinstance(active, torch.Tensor) and active.device == device \
            and active.dtype == torch.int32:
        mask = active
    else:
        mask = torch.as_tensor(np.asarray(active, dtype=np.int32),
                               device=device)
    if tuple(mask.shape) != (lanes,):
        raise ValueError(f"active has shape {tuple(mask.shape)}, "
                         f"expected ({lanes},)")
    return mask.contiguous()


def banded_factorize_batched_cuda(band, invL, d, active, nb: int, b: int,
                                  bw: int):
    """K3: K1 on every lane of ``band (B, nb+bw, bw+1, b, b)`` whose
    ``active`` (B,) entry is nonzero, in place, writing ``invL (B, nb+bw,
    b, b)`` and ``d (B, nb·b)``; inactive lanes are left untouched.
    ``active``: a numpy bool array (B,)."""
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    if not band.is_cuda:
        raise ValueError("banded_factorize_batched_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    B, nbp = band.shape[0], nb + bw
    _check("band", band, (B, nbp, bw + 1, b, b), band.dtype, band.device)
    _check("invL", invL, (B, nbp, b, b), band.dtype, band.device)
    _check("d", d, (B, nb * b), band.dtype, band.device)
    mask = _active_mask(active, B, band.device)
    xbuf = torch.empty((B, bw * b, b), dtype=band.dtype, device=band.device)
    fn = getattr(load(), "banded_factorize_batched_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 xbuf.data_ptr(), mask.data_ptr(), B, nb, b, bw, stream)
    banded_factorize_batched_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_factorize_batched_cuda: CUDA error {err}")
    return band, invL, d


banded_factorize_batched_cuda.launches = 0


def banded_solve_batched_cuda(band, invL, d, rhs, active):
    """K4: K2 on every active lane of ``rhs (B, (nb+bw)·b, k)`` (permuted,
    zero padded) with the factor from :func:`banded_factorize_batched_cuda`,
    in place, one cluster per lane; inactive lanes are left untouched.
    ``active``: numpy bool (B,), or int32 (B,) on the card."""
    B = band.shape[0]
    nb, b, bw, k = _check_solve("banded_solve_batched_cuda", band, invL, d,
                                rhs, B)
    mask = _active_mask(active, B, band.device)
    err = _launch_cluster_solve(band, invL, d, rhs, mask, B, nb, b, bw, k)
    banded_solve_batched_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_solve_batched_cuda: CUDA error {err}")
    return rhs


banded_solve_batched_cuda.launches = 0


def banded_solve_reference_cuda(band, invL, d, rhs, active=None):
    """The reference solve that K2 and K4 replaced (one CTA of 1024
    threads per lane runs both sweeps), kept as their card-side witness:
    one system (``band`` 4-D, as K2 takes it) or a batch (5-D, as K4, with
    ``active``: numpy bool (B,), or None for every lane), in place."""
    lanes = band.shape[0] if band.ndim == 5 else None
    nb, b, bw, k = _check_solve("banded_solve_reference_cuda", band, invL,
                                d, rhs, lanes)
    mask = None if active is None else _active_mask(active, lanes or 1,
                                                   band.device)
    fn = getattr(load(), "banded_solve_reference_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 rhs.data_ptr(), None if mask is None else mask.data_ptr(),
                 lanes or 1, nb, b, bw, k, stream)
    banded_solve_reference_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_solve_reference_cuda: CUDA error {err}")
    return rhs


banded_solve_reference_cuda.launches = 0


def banded_diag_step_cuda(A, R, dout, tiled: bool = True):
    """The diagonal step of K1 and K3 alone: LDLᵀ and L⁻¹ of each
    lower-stored block ``A (lanes, b, b)``, in place, one CTA per block:
    ``A[i]`` <- strict-lower L + diag(d) (upper zero), ``R[i]`` <- L⁻¹,
    ``dout[i]`` <- d.  ``tiled=False`` runs the scalar routine that K5's witness keeps
    (``diag_ldlt_block``), which the tiled one equals bit for bit."""
    if not A.is_cuda:
        raise ValueError("banded_diag_step_cuda needs CUDA tensors")
    if A.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError("A must be (lanes, b, b)")
    lanes, b, _ = A.shape
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    _check("A", A, (lanes, b, b), A.dtype, A.device)
    _check("R", R, (lanes, b, b), A.dtype, A.device)
    _check("dout", dout, (lanes, b), A.dtype, A.device)
    fn = getattr(load(), "banded_diag_step_" + _SUFFIX[A.dtype])
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(A.data_ptr(), R.data_ptr(), dout.data_ptr(), lanes, b,
                 int(tiled), stream)
    banded_diag_step_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_diag_step_cuda: CUDA error {err}")
    return A, R, dout


banded_diag_step_cuda.launches = 0

KERNELS = (banded_factorize_cuda, banded_solve_cuda,
           banded_factorize_batched_cuda, banded_solve_batched_cuda,
           banded_diag_step_cuda, banded_solve_reference_cuda)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    """Launches of each kernel since the last :func:`reset_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


# -- the solver's entry points: the device picks the backend --------------


def _route(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise NotImplementedError(f"no banded backend for device {t.device}")


def factorize(struct: BandStructure, band: torch.Tensor) -> BandedFactor:
    """Block-banded LDLᵀ of an assembled band (consumed: factored in place
    on the card)."""
    if _route(band) == "plain":
        return plain.banded_factorize(struct, band)
    b, nb, nbp = struct.b, struct.nb, struct.nbp
    band = band.contiguous()
    invL = torch.zeros((nbp, b, b), dtype=band.dtype, device=band.device)
    d = torch.ones((nbp * b,), dtype=band.dtype, device=band.device)
    banded_factorize_cuda(band, invL, d, nb, b, struct.bw)
    return BandedFactor(band=band, invL=invL, d=d[: nb * b])


def solve(struct: BandStructure, f: BandedFactor, rhs: torch.Tensor):
    """Solve in PERMUTED coordinates; ``rhs``: (N,) or (N, k)."""
    if _route(rhs) == "plain":
        return plain.banded_solve(struct, f, rhs)
    work = plain.pad_rhs(struct, rhs)
    banded_solve_cuda(f.band, f.invL, f.d, work)
    x = work[: struct.N]
    return x[:, 0] if rhs.ndim == 1 else x


def factorize_batched(struct: BandStructure, band: torch.Tensor,
                      invL: torch.Tensor, d: torch.Tensor,
                      active) -> BandedFactor:
    """Batched block-banded LDLᵀ, in place: the lanes of ``band (B, nbp,
    bw+1, b, b)`` that ``active`` (numpy bool (B,)) selects are factored
    into ``band``, ``invL (B, nbp, b, b)`` and ``d (B, nb·b)``; the other
    lanes keep what the three tensors held."""
    if _route(band) == "plain":
        plain.factorize_columns_batched(band, invL, d, active, struct.nb,
                                        struct.b, struct.bw)
    else:
        banded_factorize_batched_cuda(band, invL, d, active, struct.nb,
                                      struct.b, struct.bw)
    return BandedFactor(band=band, invL=invL, d=d)


def solve_batched(struct: BandStructure, f: BandedFactor, rhs: torch.Tensor,
                  active):
    """Batched solve in PERMUTED coordinates; ``rhs``: (B, N) or (B, N, k).
    Lanes that ``active`` leaves out return their right-hand side."""
    if _route(rhs) == "plain":
        return plain.banded_solve_batched(struct, f, rhs, active)
    work = plain.pad_rhs_batched(struct, rhs)
    banded_solve_batched_cuda(f.band, f.invL, f.d, work, active)
    x = work[:, : struct.N]
    return x[..., 0] if rhs.ndim == 2 else x
