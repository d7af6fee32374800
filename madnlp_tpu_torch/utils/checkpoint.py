"""Solver-state checkpointing — port of ``madnlp_tpu/utils/checkpoint.py``.

The port's :class:`~madnlp_tpu_torch.ipm.state.State` is a dataclass of
tensors, host scalars and small named tuples, so a checkpoint is one
``.npz`` entry per leaf, keyed by its field path: ``"x"``, ``"mu"``,
``"d.xp"``, ``"filter.th"``, ``"scal.con_scale"``, ``"RR.pp"``,
``"RR.filter.count"``, ``"qn.Sk"``, ``"hess.U"`` (a low-rank Hessian),
``"ctx.factor.inner.band"`` (the persisted KKT context), ``"theta"`` … (a
``None`` leaf — the parameters of a model that takes none, the context
under the monotone barrier — is not stored; the items of a plain tuple
are keyed by position).  Tensors are stored as their numpy arrays, floats
as float64, ints as int64, flags as bool and strings as unicode.

:func:`load_state` is strict: a field missing from the file, a field the
template does not have, or a leaf of another shape or dtype raises
``ValueError`` naming the field.  The one exception is the JAX package's:
the persisted KKT context ``ctx`` (and every field under it) takes the
template's value where the file lacks it, has it in another shape or
dtype, or the template has none, and the file's extra ``ctx`` fields are
ignored.  The context is a factorization that an adaptive barrier's next
probing solves read and the monotone rule never keeps, so a checkpoint
written under one barrier rule loads under the other.  Everything else,
the quasi-Newton memory and the low-rank Hessian included, loads strictly.
Loaded tensors take the template's device and dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


_CTX = "ctx"


def _is_record(v) -> bool:
    return dataclasses.is_dataclass(v) or isinstance(v, tuple)


def _children(v):
    if dataclasses.is_dataclass(v):
        return [(f.name, getattr(v, f.name)) for f in dataclasses.fields(v)]
    if hasattr(v, "_fields"):
        return list(zip(v._fields, v))
    return [(str(i), child) for i, child in enumerate(v)]


def _rebuild(tmpl, parts: dict):
    if dataclasses.is_dataclass(tmpl) or hasattr(tmpl, "_fields"):
        return type(tmpl)(**parts)
    return tuple(parts[str(i)] for i in range(len(tmpl)))


def _as_array(v) -> np.ndarray:
    """A leaf as the array it is stored as."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, bool):
        return np.asarray(v, dtype=np.bool_)
    if isinstance(v, int):
        return np.asarray(v, dtype=np.int64)
    if isinstance(v, float):
        return np.asarray(v, dtype=np.float64)
    if isinstance(v, list):      # the iteration-log row
        return np.asarray(v, dtype=np.float64)
    if isinstance(v, str):       # a dense factor's kind
        return np.asarray(v)
    raise TypeError(f"cannot checkpoint a leaf of type {type(v).__name__}")


def state_arrays(state) -> dict:
    """The leaves of ``state`` as numpy arrays, keyed by field path."""
    out = {}

    def walk(v, key):
        if v is None:
            return
        if _is_record(v):
            for name, child in _children(v):
                walk(child, f"{key}.{name}" if key else name)
        else:
            out[key] = _as_array(v)

    walk(state, "")
    return out


def save_state(state, path: str) -> None:
    np.savez(path, **state_arrays(state))


def _restore_leaf(tmpl, arr: np.ndarray, key: str):
    want = _as_array(tmpl)
    if arr.shape != want.shape or arr.dtype != want.dtype:
        raise ValueError(
            f"checkpoint field {key!r}: {arr.dtype}{list(arr.shape)}, the "
            f"template has {want.dtype}{list(want.shape)}")
    if torch.is_tensor(tmpl):
        return torch.as_tensor(arr, dtype=tmpl.dtype, device=tmpl.device)
    if isinstance(tmpl, np.ndarray):
        return arr.copy()
    if isinstance(tmpl, list):
        return [float(v) for v in arr]
    return type(tmpl)(arr.item())


def _same_layout(tmpl, arr: np.ndarray) -> bool:
    want = _as_array(tmpl)
    return arr.shape == want.shape and arr.dtype == want.dtype


def load_state(path: str, template):
    """Restore a state saved by :func:`save_state` into the structure of
    ``template`` (a state of the same solver configuration, e.g.
    ``solver.kernel.zero_state(...)`` or a previous state).  Strict: any
    field missing, extra, or of another shape or dtype raises
    ``ValueError``, except under the persisted KKT context ``ctx``, which
    keeps the template's value for such a field."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as f:
        data = {k: f[k] for k in f.files}
    used = {k for k in data if k == _CTX or k.startswith(_CTX + ".")}

    def build(tmpl, key, lenient):
        if tmpl is None:
            return None
        if _is_record(tmpl):
            parts = {}
            for name, child in _children(tmpl):
                sub = f"{key}.{name}" if key else name
                parts[name] = build(child, sub, lenient or sub == _CTX)
            return _rebuild(tmpl, parts)
        if lenient:
            # the persisted KKT context: the template's value unless the
            # file holds the same leaf
            if key in data and _same_layout(tmpl, data[key]):
                return _restore_leaf(tmpl, data[key], key)
            return tmpl
        if key not in data:
            raise ValueError(f"checkpoint lacks field {key!r}")
        used.add(key)
        return _restore_leaf(tmpl, data[key], key)

    state = build(template, "", False)
    extra = sorted(set(data) - used)
    if extra:
        raise ValueError(f"checkpoint has fields the template lacks: {extra}")
    return state


def resume(solver, path: str):
    """Load a checkpoint into ``solver.state``; drive it on with the
    kernel's step functions, or call ``solver.solve()``, which warm-starts
    from it (``Kernel.reinitialize``), as the JAX package does."""
    template = solver.state
    if template is None:
        template = solver.kernel.zero_state(solver._params(None))
    solver.state = load_state(path, template)
    return solver.state
