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
  holding it bit for bit against the scalar routine K5 keeps.

All four are CUDA C++ for ``sm_90a`` in ``csrc/banded_ldlt.cu`` (K3 and K4
run K1's and K2's kernel bodies with a lane index), compiled by ``nvcc``
into ``build/kernels/`` at first use and loaded with ``ctypes``.  Each
wrapper checks device, dtype, shape and contiguity, allocates the scratch
it needs with ``torch.empty``, launches on the current stream, raises if
the C entry returns a CUDA error, and counts its launches in its
``launches`` attribute.

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
        for name in ("banded_solve_f32", "banded_solve_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_factorize_batched_f32",
                     "banded_factorize_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
            fn.restype = ci
        for name in ("banded_solve_batched_f32", "banded_solve_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
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


def banded_solve_cuda(band, invL, d, rhs):
    """K2: solve in place on ``rhs ((nb+bw)·b, k)`` (permuted, zero
    padded) with the factor from :func:`banded_factorize_cuda`; the padding
    rows of the result are zero."""
    if not band.is_cuda:
        raise ValueError("banded_solve_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    nbp, bw1, b, _ = band.shape
    bw = bw1 - 1
    nb = nbp - bw
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    _check("band", band, (nbp, bw1, b, b), band.dtype, band.device)
    _check("invL", invL, (nbp, b, b), band.dtype, band.device)
    if d.numel() < nb * b or not d.is_contiguous() or d.dtype != band.dtype \
            or d.device != band.device:
        raise ValueError("d must be a contiguous vector of ≥ nb·b pivots "
                         "of the band's dtype and device")
    if rhs.ndim != 2:
        raise ValueError("rhs must be 2-D ((nb+bw)·b, k)")
    _check("rhs", rhs, (nbp * b, rhs.shape[1]), band.dtype, band.device)
    fn = getattr(load(), "banded_solve_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 rhs.data_ptr(), nb, b, bw, rhs.shape[1], stream)
    banded_solve_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_solve_cuda: CUDA error {err}")
    return rhs


banded_solve_cuda.launches = 0


def _active_mask(active, lanes: int, device) -> torch.Tensor:
    """The lane mask (numpy bool (B,)) as the kernels read it: int32 (B,)
    on the card."""
    mask = torch.as_tensor(np.asarray(active, dtype=np.int32), device=device)
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
    in place; inactive lanes are left untouched."""
    if not band.is_cuda:
        raise ValueError("banded_solve_batched_cuda needs CUDA tensors")
    if band.dtype not in _SUFFIX:
        raise TypeError(f"unsupported dtype {band.dtype}")
    if band.ndim != 5 or rhs.ndim != 3:
        raise ValueError("band must be (B, nb+bw, bw+1, b, b) and rhs "
                         "(B, (nb+bw)·b, k)")
    B, nbp, bw1, b, _ = band.shape
    bw = bw1 - 1
    nb = nbp - bw
    if b not in SUPPORTED_BLOCKS:
        raise ValueError(f"block size {b} not in {SUPPORTED_BLOCKS}")
    _check("band", band, (B, nbp, bw1, b, b), band.dtype, band.device)
    _check("invL", invL, (B, nbp, b, b), band.dtype, band.device)
    _check("d", d, (B, nb * b), band.dtype, band.device)
    _check("rhs", rhs, (B, nbp * b, rhs.shape[2]), band.dtype, band.device)
    mask = _active_mask(active, B, band.device)
    fn = getattr(load(), "banded_solve_batched_" + _SUFFIX[band.dtype])
    with torch.cuda.device(band.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(band.data_ptr(), invL.data_ptr(), d.data_ptr(),
                 rhs.data_ptr(), mask.data_ptr(), B, nb, b, bw, rhs.shape[2],
                 stream)
    banded_solve_batched_cuda.launches += 1
    if err:
        raise RuntimeError(f"banded_solve_batched_cuda: CUDA error {err}")
    return rhs


banded_solve_batched_cuda.launches = 0

def banded_diag_step_cuda(A, R, dout, tiled: bool = True):
    """The diagonal step of K1 and K3 alone: LDLᵀ and L⁻¹ of each
    lower-stored block ``A (lanes, b, b)``, in place, one CTA per block:
    ``A[i]`` <- strict-lower L + diag(d) (upper zero), ``R[i]`` <- L⁻¹,
    ``dout[i]`` <- d.  ``tiled=False`` runs the scalar routine that K5 keeps
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
           banded_diag_step_cuda)


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
