"""The Hopper kernel of the whole-matrix dense LDLᵀ (K7) and its wrapper.

K7 :func:`dense_ldlt_cuda` replaces ``madnlp_tpu/ops/pallas_ldlt.py:
pallas_ldlt`` (body ``_ldlt_kernel``): the blocked, right-looking,
unpivoted LDLᵀ of a whole symmetric matrix, in place.  It is CUDA C++ for
``sm_90a`` in ``csrc/dense_ldlt.cu``, compiled by ``nvcc`` into
``build/kernels/`` at first use and loaded with ``ctypes``; nothing is
built or imported until a CUDA tensor arrives.  It takes every block size
1 ≤ b ≤ ``MAX_BLOCK`` = 128: one CTA holds the diagonal block.

:func:`dense_ldlt` is the public function and the dense path's LDLᵀ
(``ops/dense_solvers.py:factorize`` with ``LinearSolver.LDL``): for a
tensor on the card it launches K7 (or raises), for a tensor on the CPU it
runs :func:`dense_ldlt_plain`, which follows ``pallas_ldlt``'s algorithm
step by step (rank-1 diagonal block, L_kk⁻¹ by forward substitution,
panel, trailing update) and returns what ``pallas_ldlt`` returns.  It is
the same function by the same recursion as the JAX package's XLA code
(:func:`..ldlt.ldlt_factorize`), which forms L_kk⁻¹ by a triangular solve.

:func:`dense_ldlt_reference_cuda` launches the first version of K7, kept
as the card-side witness of the redesigned kernel (equal bit for bit at
the blocks it takes, 32, 64 and 128); no solve path reaches it.
"""

from __future__ import annotations

import ctypes
import os

import torch

from .banded_kernels import _SUFFIX, BUILD_DIR, compile_library
from .banded import host_view
from .ldlt import LDLFactor, ldlt_unblocked, pad_identity, pivot_div

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "dense_ldlt.cu")
LIBRARY = os.path.join(BUILD_DIR, "libdense_ldlt.so")
# K7 holds the diagonal block in one CTA (in registers, and in shared memory
# for the inverse: 132 KB in float64 at b = 128)
MAX_BLOCK = 128
# the witness keeps the blocks of the first version
REFERENCE_BLOCKS = (32, 64, 128)

_lib = None


def build(force: bool = False, ptxas_info: bool = False) -> str:
    """Compile ``csrc/dense_ldlt.cu`` (see
    :func:`.banded_kernels.compile_library`)."""
    return compile_library(SOURCE, LIBRARY, force, ptxas_info)


def load():
    """Build (if needed) and load the kernel library; returns the handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name in ("dense_ldlt_f32", "dense_ldlt_f64",
                     "dense_ldlt_reference_f32", "dense_ldlt_reference_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, ci, ci, vp]
            fn.restype = ci
        _lib = lib
    return _lib


def check_block(block: int):
    """K7's limit on the block size, checked before anything else."""
    if not 1 <= block <= MAX_BLOCK:
        raise ValueError(f"block size {block} outside 1..{MAX_BLOCK}: on the "
                         f"card one CTA holds the diagonal block")


def _check(name: str, out: torch.Tensor, block: int):
    if not out.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if out.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {out.dtype}")
    if out.ndim != 2 or out.shape[0] != out.shape[1] or out.shape[0] % block:
        raise ValueError(f"out must be square with a side that is a multiple "
                         f"of {block}, got {tuple(out.shape)}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def _launch(name: str, out: torch.Tensor, block: int, xbufs: int):
    np_ = out.shape[0]
    rt = torch.empty((block, block), dtype=out.dtype, device=out.device)
    xbuf = torch.empty((xbufs, max(np_ - block, 1), block), dtype=out.dtype,
                       device=out.device)
    fn = getattr(load(), name + "_" + _SUFFIX[out.dtype])
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(out.data_ptr(), rt.data_ptr(), xbuf.data_ptr(), np_, block,
                  stream)


def dense_ldlt_cuda(out: torch.Tensor, block: int) -> torch.Tensor:
    """K7: factor the symmetric ``out (Np, Np)`` (Np a multiple of
    ``block``, 1 ≤ block ≤ 128, lower triangle read) in place: its strict
    lower triangle becomes L and its diagonal D.  float32 or float64."""
    check_block(block)
    _check("dense_ldlt_cuda", out, block)
    # X of the even and the odd block columns (the look-ahead)
    err = _launch("dense_ldlt", out, block, 2)
    dense_ldlt_cuda.launches += 1
    if err:
        raise RuntimeError(f"dense_ldlt_cuda: CUDA error {err}")
    return out


dense_ldlt_cuda.launches = 0


def dense_ldlt_reference_cuda(out: torch.Tensor, block: int) -> torch.Tensor:
    """The witness: the first version of K7 (one stream, four launches per
    block column), which the redesigned :func:`dense_ldlt_cuda` equals bit
    for bit on the strict lower triangle and the diagonal.  Blocks 32, 64
    and 128."""
    if block not in REFERENCE_BLOCKS:
        raise ValueError(f"block size {block} not in {REFERENCE_BLOCKS}")
    _check("dense_ldlt_reference_cuda", out, block)
    err = _launch("dense_ldlt_reference", out, block, 1)
    dense_ldlt_reference_cuda.launches += 1
    if err:
        raise RuntimeError(f"dense_ldlt_reference_cuda: CUDA error {err}")
    return out


dense_ldlt_reference_cuda.launches = 0

KERNELS = (dense_ldlt_cuda, dense_ldlt_reference_cuda)


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    """Launches of each kernel since the last :func:`reset_counts`."""
    return {k.__name__: k.launches for k in KERNELS}


# -- the plain version ---------------------------------------------------------


def _unit_lower_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit lower-triangular (b, b) matrix by forward
    substitution (``pallas_ldlt._unit_lower_inverse``)."""
    b = L.shape[0]
    X = torch.eye(b, dtype=L.dtype, device=L.device)
    H, Lh = host_view(X), host_view(L)
    for j in range(b - 1):
        H[j + 1:, : j + 1] -= Lh[j + 1:, j, None] * H[j, None, : j + 1]
    return X


def dense_ldlt_plain(A: torch.Tensor, block: int = 128) -> LDLFactor:
    """The plain torch version of K7, step by step as
    ``pallas_ldlt(A, block)``, with its output: ``LDLFactor(L = tril(out,
    -1) + I, d = diag(out), n)`` over the identity-padded
    ``Np = ⌈N/block⌉·block``."""
    n = A.shape[0]
    out = pad_identity(A, block).clone()
    np_ = out.shape[0]
    for kb in range(0, np_, block):
        s = kb + block
        # the diagonal block by rank-1 steps (pallas_ldlt._unblocked_ldlt)
        LD = ldlt_unblocked(out[kb:s, kb:s])
        Lkk = torch.tril(LD, -1) + torch.eye(block, dtype=A.dtype,
                                             device=A.device)
        dk = torch.diagonal(LD).clone()
        invLkk = _unit_lower_inverse(Lkk)
        X = out[s:, kb:s] @ invLkk.T
        Lcol = X / pivot_div(dk)
        out[s:, s:] -= Lcol @ X.T
        out[:kb, kb:s] = 0.0
        out[s:, kb:s] = Lcol
        out[kb:s, kb:s] = torch.tril(Lkk, -1) + torch.diag(dk)
    return _factor_of(out, n)


def _factor_of(out: torch.Tensor, n: int) -> LDLFactor:
    np_ = out.shape[0]
    L = torch.tril(out, -1) + torch.eye(np_, dtype=out.dtype, device=out.device)
    return LDLFactor(L=L, d=torch.diagonal(out).clone(), n=n)


def dense_ldlt(A: torch.Tensor, block: int = 128) -> LDLFactor:
    """Whole-matrix blocked LDLᵀ of the symmetric ``A (N, N)`` — the
    counterpart of ``madnlp_tpu/ops/pallas_ldlt.py:pallas_ldlt``, for any N
    (the TPU kernel's VMEM budget ``MAX_VMEM_N`` does not apply).  A CUDA
    tensor runs K7 (block ≤ 128, else ``ValueError``), a CPU tensor
    :func:`dense_ldlt_plain` (any block)."""
    if A.device.type == "cpu":
        return dense_ldlt_plain(A, block)
    if not A.is_cuda:
        raise NotImplementedError(f"no dense LDLᵀ backend for {A.device}")
    check_block(block)
    out = pad_identity(A, block).clone().contiguous()
    return _factor_of(dense_ldlt_cuda(out, block), A.shape[0])


def dense_ldlt_reference(A: torch.Tensor, block: int = 128) -> LDLFactor:
    """:func:`dense_ldlt` through the witness (CUDA tensors only)."""
    out = pad_identity(A, block).clone().contiguous()
    return _factor_of(dense_ldlt_reference_cuda(out, block), A.shape[0])
