"""KKT right-hand-side / direction vectors — port of
``madnlp_tpu/kkt/vec.py``: four full-length masked float64 tensors.

* ``xp``  (nw,)  primal (variables + slacks)
* ``y``   (m,)   constraint duals
* ``zl``  (nw,)  lower-bound duals — zero where the component has no lower bound
* ``zu``  (nw,)  upper-bound duals — zero where no upper bound

A batch of solves carries a leading lane axis on every part: ``(B, nw)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KKTVec(NamedTuple):
    xp: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor

    def axpy(self, alpha, other: "KKTVec") -> "KKTVec":
        return KKTVec(*(a + alpha * b for a, b in zip(self, other)))

    def scale(self, alpha) -> "KKTVec":
        return KKTVec(*(alpha * a for a in self))


def kkt_zeros(nw: int, m: int, device=None, lanes: int = None) -> KKTVec:
    lead = () if lanes is None else (lanes,)

    def z(k):
        return torch.zeros(lead + (k,), dtype=torch.float64, device=device)

    return KKTVec(xp=z(nw), y=z(m), zl=z(nw), zu=z(nw))


def lane_where(mask: torch.Tensor, a, b):
    """Lane by lane: ``a`` where the bool ``mask`` (B,) holds, else ``b``;
    over tensors with a leading lane axis or trees of tuples of them (a
    KKTVec, a KKT context, an SMW payload), None staying None."""
    if a is None:
        return None
    if isinstance(a, tuple):
        items = [lane_where(mask, x, y) for x, y in zip(a, b)]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return torch.where(mask.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)


def norm_inf(v: KKTVec) -> torch.Tensor:
    """max |·| over all four parts (per lane), as a tensor (no host sync)."""
    parts = [a.abs().amax(-1) for a in v if a.shape[-1]]
    return torch.stack(parts).amax(0)
