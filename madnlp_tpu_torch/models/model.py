"""NLP model protocol of the PyTorch port — port of
``madnlp_tpu/models/model.py`` (``DenseNLPModel``, ``SparseNLPModel``,
``NLPModel``, ``create_model``):

    min_x f(x)   s.t.   g_l <= g(x) <= g_u,   x_l <= x <= x_u

Two derivative interfaces, as in the JAX package.

:class:`DenseNLPModel` has dense callbacks ``jac(x) -> (m, n)`` and
``lag_hess(x, y, obj_weight) -> (n, n)``; whatever the user leaves out
comes from ``torch.func`` (``grad`` of the objective, ``jacfwd`` of the
constraints, ``hessian`` of the Lagrangian), as JAX AD provides it in the
reference.  Its callables must therefore be written with torch operations
that ``torch.func`` can transform (``torch.stack`` / ``torch.cat`` to build
vectors, no in-place updates of the input).

:class:`SparseNLPModel` has a static COO structure: ``jac_rows/jac_cols``
for the Jacobian and ``hess_rows/hess_cols`` for the **lower-triangular**
Lagrangian Hessian, both host-side numpy; :meth:`SparseNLPModel.to_dense`
turns it into a dense model by deterministic gathers.  Its callables:

* ``obj(x) -> ()``, ``cons(x) -> (m,)``, ``grad(x) -> (n,)``;
* ``jac_coords(x) -> (nnzj,)``;
* ``hess_coords(x, y, obj_weight) -> (nnzh,)``.

Every callable takes and returns float64 torch tensors on the caller's
device.  A *parametric* model (``params`` set to an example parameter array) takes
the parameters as one more trailing argument of every callable:
``obj(x, θ)``, ``cons(x, θ)``, ``grad(x, θ)``, ``jac_coords(x, θ)``,
``hess_coords(x, y, obj_weight, θ)``.  ``MadNLPSolver.solve_batch``
evaluates them on a batch: ``x (B, n)``, ``y (B, m)``, ``θ (B,)`` and an
``obj_weight`` of shape ``(B, 1)``, so the callables must broadcast over
one leading lane axis (as the instances of this package do).  A
parametric dense model keeps ``params`` and ``x0_fn`` (parameters -> x0) as
fields; batching it comes in a later slice of the port.

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

from ..ops.segment import segment_map, segment_sum


def _as_np(x, n, default):
    if x is None:
        return np.full((n,), default, dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def to_tensor(a, device) -> torch.Tensor:
    """Host array -> tensor on ``device``: bool stays bool, integers become
    int64 (index maps), complex complex128, everything else float64."""
    a = np.asarray(a)
    if a.dtype == bool:
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = torch.int64
    elif a.dtype.kind == "c":
        dtype = torch.complex128
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


def _func_derivatives(model):
    """Fill in the dense model's missing derivative callables with
    ``torch.func`` transforms of ``obj`` and ``cons``."""
    n, m = model.n, model.m
    obj, cons = model.obj, model.cons
    if model.grad is None:
        model.grad = torch.func.grad(obj)
    if model.jac is None:
        if m > 0:
            model.jac = torch.func.jacfwd(cons)
        else:
            def jac(x, *params):
                return x.new_zeros((0, n))
            model.jac = jac
    if model.lag_hess is None:
        def lag_hess(x, y, obj_weight, *params):
            def lagrangian(xx):
                val = obj_weight * obj(xx, *params)
                if m > 0:
                    val = val + torch.dot(y, cons(xx, *params))
                return val
            return torch.func.hessian(lagrangian)(x)
        model.lag_hess = lag_hess


@dataclasses.dataclass
class DenseNLPModel:
    """NLP with dense derivative callbacks (``torch.func`` by default).

    **Parametric mode**: with ``params`` set to example parameters, every
    callable takes them as one more trailing argument, and ``x0_fn``
    (parameters -> x0), if given, supplies the initial point."""

    n: int
    obj: Callable
    x0: np.ndarray
    m: int = 0
    cons: Optional[Callable] = None
    lvar: Optional[np.ndarray] = None
    uvar: Optional[np.ndarray] = None
    lcon: Optional[np.ndarray] = None
    ucon: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    grad: Optional[Callable] = None
    jac: Optional[Callable] = None
    lag_hess: Optional[Callable] = None  # (x, y, obj_weight[, params]) -> (n, n)
    minimize: bool = True
    name: str = "generic"
    params: object = None          # example parameters (parametric mode)
    x0_fn: Optional[Callable] = None  # params -> x0 (parametric initial point)

    def __post_init__(self):
        self.x0 = np.asarray(self.x0, dtype=np.float64)
        self.lvar = _as_np(self.lvar, self.n, -np.inf)
        self.uvar = _as_np(self.uvar, self.n, np.inf)
        self.lcon = _as_np(self.lcon, self.m, 0.0)
        self.ucon = _as_np(self.ucon, self.m, 0.0)
        self.y0 = _as_np(self.y0, self.m, 0.0)
        if self.cons is None:
            if self.m != 0:
                raise ValueError("a model with m > 0 constraints needs cons")

            def cons(x, *params):
                return x.new_zeros((0,))
            self.cons = cons
        _func_derivatives(self)

    @property
    def is_dense(self) -> bool:
        return True

    @property
    def is_parametric(self) -> bool:
        return self.params is not None


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
    def is_dense(self) -> bool:
        return False

    @property
    def is_parametric(self) -> bool:
        return self.params is not None

    def _dense_maps(self) -> "DeviceConstants":
        """Gather maps that densify the COO values deterministically: the
        distinct flat positions of each structure and, per position, the
        table of the entries that sum into it."""
        if getattr(self, "_dense_consts", None) is None:
            jpos = self.jac_rows * self.n + self.jac_cols
            hpos = self.hess_rows * self.n + self.hess_cols
            jflat, jinv = np.unique(jpos, return_inverse=True)
            hflat, hinv = np.unique(hpos, return_inverse=True)
            self._dense_consts = DeviceConstants(
                jflat=jflat, jtable=segment_map(jinv.ravel(), len(jflat)),
                hflat=hflat, htable=segment_map(hinv.ravel(), len(hflat)))
        return self._dense_consts

    def jac_dense(self, x, *params):
        """The (m, n) Jacobian from its COO values (duplicates summed)."""
        k = self._dense_maps().on(x.device)
        vals = self.jac_coords(x, *params)
        out = vals.new_zeros((self.m * self.n,))
        out[k.jflat] = segment_sum(vals, k.jtable)
        return out.reshape(self.m, self.n)

    def lag_hess_dense(self, x, y, obj_weight, *params):
        """The full symmetric (n, n) Hessian from its lower-triangular COO
        values."""
        k = self._dense_maps().on(x.device)
        vals = self.hess_coords(x, y, obj_weight, *params)
        out = vals.new_zeros((self.n * self.n,))
        out[k.hflat] = segment_sum(vals, k.htable)
        out = out.reshape(self.n, self.n)
        return out + torch.tril(out, -1).T

    def to_dense(self) -> DenseNLPModel:
        return DenseNLPModel(
            n=self.n, m=self.m, obj=self.obj, cons=self.cons, x0=self.x0,
            lvar=self.lvar, uvar=self.uvar, lcon=self.lcon, ucon=self.ucon,
            y0=self.y0, grad=self.grad, jac=self.jac_dense,
            lag_hess=self.lag_hess_dense, minimize=self.minimize,
            name=self.name, params=self.params,
        )


NLPModel = DenseNLPModel  # default public alias


def create_model(obj: Callable, n: int, x0, cons: Optional[Callable] = None,
                 m: int = 0, **kwargs) -> DenseNLPModel:
    """Define an NLP from torch functions; derivatives come from
    ``torch.func``."""
    return DenseNLPModel(n=n, m=m, obj=obj, cons=cons, x0=x0, **kwargs)
