"""NLP model protocol of the PyTorch port — the sparse-callback model.

Port of ``madnlp_tpu/models/model.py:SparseNLPModel``:

    min_x f(x)   s.t.   g_l <= g(x) <= g_u,   x_l <= x <= x_u

``jac_rows/jac_cols`` give the COO structure of the Jacobian and
``hess_rows/hess_cols`` the **lower-triangular** structure of the
Lagrangian Hessian; both are host-side numpy.  The callables take and return
torch tensors on the caller's device (float64):

* ``obj(x) -> ()``, ``cons(x) -> (m,)``, ``grad(x) -> (n,)``;
* ``jac_coords(x) -> (nnzj,)``;
* ``hess_coords(x, y, obj_weight) -> (nnzh,)``.

A *parametric* model (``params`` set to an example parameter array) takes
the parameters as one more trailing argument of every callable:
``obj(x, θ)``, ``cons(x, θ)``, ``grad(x, θ)``, ``jac_coords(x, θ)``,
``hess_coords(x, y, obj_weight, θ)``.  ``MadNLPSolver.solve_batch``
evaluates them on a batch: ``x (B, n)``, ``y (B, m)``, ``θ (B,)`` and an
``obj_weight`` of shape ``(B, 1)``, so the callables must broadcast over
one leading lane axis (as the instances of this package do).

A model's constant data lives host-side in numpy and is materialised on a
device the first time a callable sees a tensor there
(:class:`DeviceConstants`), so one model serves both the CPU and the card.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Callable, Optional

import numpy as np
import torch


def _as_np(x, n, default):
    if x is None:
        return np.full((n,), default, dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def to_tensor(a, device) -> torch.Tensor:
    """Host array -> tensor on ``device``: bool stays bool, integers become
    int64 (index maps), everything else float64."""
    a = np.asarray(a)
    if a.dtype == bool:
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = torch.int64
    else:
        dtype = torch.float64
    return torch.as_tensor(a, dtype=dtype, device=device)


class DeviceConstants:
    """Numpy constants of a model, copied once to each device that asks:
    ``consts.on(x.device).name`` is the tensor of array ``name``."""

    def __init__(self, **arrays):
        self._arrays = arrays
        self._by_device = {}

    def on(self, device) -> types.SimpleNamespace:
        key = str(device)
        if key not in self._by_device:
            self._by_device[key] = types.SimpleNamespace(**{
                k: to_tensor(v, device) for k, v in self._arrays.items()
            })
        return self._by_device[key]


def _autograd_grad(obj):
    def grad(x, *params):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            # the sum over lanes leaves each lane's gradient in its row
            (g,) = torch.autograd.grad(obj(xx, *params).sum(), xx)
        return g.detach()

    return grad


@dataclasses.dataclass
class SparseNLPModel:
    """NLP with static sparse derivative structure and torch callables."""

    n: int
    m: int
    obj: Callable
    cons: Callable
    x0: np.ndarray
    jac_rows: np.ndarray
    jac_cols: np.ndarray
    jac_coords: Callable          # x -> (nnzj,)
    hess_rows: np.ndarray
    hess_cols: np.ndarray
    hess_coords: Callable         # (x, y, obj_weight) -> (nnzh,)
    lvar: Optional[np.ndarray] = None
    uvar: Optional[np.ndarray] = None
    lcon: Optional[np.ndarray] = None
    ucon: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    grad: Optional[Callable] = None
    minimize: bool = True
    name: str = "generic-sparse"
    params: object = None          # example parameters (parametric mode)

    def __post_init__(self):
        self.x0 = np.asarray(self.x0, dtype=np.float64)
        self.lvar = _as_np(self.lvar, self.n, -np.inf)
        self.uvar = _as_np(self.uvar, self.n, np.inf)
        self.lcon = _as_np(self.lcon, self.m, 0.0)
        self.ucon = _as_np(self.ucon, self.m, 0.0)
        self.y0 = _as_np(self.y0, self.m, 0.0)
        self.jac_rows = np.asarray(self.jac_rows, dtype=np.int64)
        self.jac_cols = np.asarray(self.jac_cols, dtype=np.int64)
        self.hess_rows = np.asarray(self.hess_rows, dtype=np.int64)
        self.hess_cols = np.asarray(self.hess_cols, dtype=np.int64)
        if self.grad is None:
            self.grad = _autograd_grad(self.obj)

    @property
    def nnzj(self) -> int:
        return len(self.jac_rows)

    @property
    def nnzh(self) -> int:
        return len(self.hess_rows)

    @property
    def is_parametric(self) -> bool:
        return self.params is not None
