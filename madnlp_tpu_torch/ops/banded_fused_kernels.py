"""The whole-band Hopper kernels of the banded LDLᵀ (K5, K6) and their
wrappers — the counterpart of ``madnlp_tpu/ops/pallas_banded.py``.

* K5 :func:`banded_fused_factorize_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded.py:_factorize_call`` (body
  ``_factorize_kernel``): the whole block-banded LDLᵀ + L_jj⁻¹ in **one**
  kernel launch, the block-column loop inside the kernel;
* K6 :func:`banded_fused_solve_cuda` replaces
  ``madnlp_tpu/ops/pallas_banded.py:_solve_call`` (body ``_solve_kernel``):
  forward sweep, z/d on the real rows and backward sweep in one kernel,
  its grid over tiles of the right-hand-side columns.

Both are CUDA C++ for ``sm_90a`` in ``csrc/banded_fused.cu`` (K5 shares
K1's diagonal step, ``csrc/banded_diag.cuh``), compiled by ``nvcc`` into
``build/kernels/`` at first use and loaded with ``ctypes``; nothing is
built or imported until a CUDA tensor arrives.

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
(which bands fit the TPU's scoped VMEM) is a rule of that memory and
stays behind; K5 takes any band and stages the diagonal block in shared
memory where it fits.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import banded as plain
from .banded import BandedFactor, BandStructure
from .banded_kernels import (
    _SUFFIX,
    BUILD_DIR,
    SUPPORTED_BLOCKS,
    _check,
    _route,
    compile_library,
)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "banded_fused.cu")
LIBRARY = os.path.join(BUILD_DIR, "libbanded_fused.so")

_lib = None


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile ``csrc/banded_fused.cu`` (see
    :func:`.banded_kernels.compile_library`)."""
    return compile_library(SOURCE, LIBRARY, force, ptxas_info)


def load():
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("banded_fused_factorize_f32", "banded_fused_factorize_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_fused_solve_f32", "banded_fused_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
        lib.banded_fused_staged.argtypes = [ci, ci]
        lib.banded_fused_staged.restype = ci
        _lib = lib
    return _lib


def staged(b: int, dtype: torch.dtype) -> bool:
    """Whether K5 stages the diagonal block and its inverse in shared memory
    at block size ``b`` (asks the kernel library)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return bool(load().banded_fused_staged(b, itemsize))


def banded_fused_factorize_cuda(band, invL, d, nb: int, b: int, bw: int):
    """K5: factor block columns 0..nb-1 of ``band (nb+bw, bw+1, b, b)`` in
    place, in one kernel launch; writes ``invL (nb+bw, b, b)`` and
    ``d (≥ nb·b,)`` for the real columns and leaves them untouched in the
    overhang.  float32 or float64."""
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    if not band.is_cuda:
        raise ValueError("banded_fused_factorize_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    nbp = nb + bw
    _check("band", band, (nbp, bw + 1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    if d.numel() < nb * b:
        raise ValueError(f"d has {d.numel()} entries, needs {nb * b}")
    _check("d", d, (d.numel(),), band.dtype, band.device)
    xbuf = torch.empty((bw * b, b), dtype=band.dtype, device=band.device)
    fn = getattr(load(), "banded_fused_factorize_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 xbuf.data_ptr(), nb, b, bw, stream)
    banded_fused_factorize_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_factorize_cuda: CUDA error {err}")
    return band, invL, d


banded_fused_factorize_cuda.launches = 0


def banded_fused_solve_cuda(band, invL, d, x):
    """K6: solve in place on ``x ((nb+bw)·b, kp)`` (permuted, zero padded,
    ``kp`` a multiple of 8) with the factor from
    :func:`banded_fused_factorize_cuda`; ``d`` holds ``(nb+bw)·b`` pivots
    of which the first ``nb·b`` are read.  The overhang rows of the result
    are don't-care."""
    if not band.is_cuda:
        raise ValueError("banded_fused_solve_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    if band.ndim != 4 or x.ndim != 2:
        raise ValueError("band must be (nb+bw, bw+1, b, b) and x "
                         "((nb+bw)·b, kp)")
    nbp, bw1, b, _ = band.shape
    bw = bw1 - 1
    nb = nbp - bw
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    _check("band", band, (nbp, bw1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    _check("d", d, (nbp * b,), band.dtype, band.device)
    kp = x.shape[1]
    if kp % 8:
        raise ValueError(f"x has {kp} columns, not a multiple of 8")
    _check("x", x, (nbp * b, kp), band.dtype, band.device)
    fn = getattr(load(), "banded_fused_solve_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(), x.data_ptr(),
                 nb, b, bw, kp, stream)
    banded_fused_solve_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_fused_solve_cuda: CUDA error {err}")
    return x


banded_fused_solve_cuda.launches = 0

KERNELS = (banded_fused_factorize_cuda, banded_fused_solve_cuda)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    """Launches of each kernel since the last :func:`reset_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


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
    return _unpadded(struct, banded_fused_solve_cuda(f.band, f.invL, d, work),
                     rhs)
