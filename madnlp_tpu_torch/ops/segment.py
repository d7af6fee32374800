"""Deterministic segment reductions through host-built padded gather maps.

The JAX package sums duplicate COO contributions with scatter-adds (or, on
the TPU, with cumsum differences and row cohorts).  On CUDA a scatter-add
with duplicate targets sums by atomics in a varying order, so two runs of
the same solve would differ in the last bits.  Here every segment sum is a
gather into a padded ``(n_out, K)`` contributor table, built once on the
host, followed by a sum along the contributor axis — the same order on every
run, on every device.  Values may carry leading (lane) axes: the segments
run over the last axis.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_map(targets: np.ndarray, n_out: int) -> np.ndarray:
    """``(n_out, K)`` table whose row ``t`` lists, in input order, the
    positions ``i`` with ``targets[i] == t``; unused slots hold
    ``len(targets)``, the position of the fill value appended by
    :func:`segment_sum` / :func:`segment_max`."""
    targets = np.asarray(targets, dtype=np.int64)
    n_in = len(targets)
    counts = np.bincount(targets, minlength=n_out)
    K = max(1, int(counts.max(initial=0)))
    order = np.argsort(targets, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.arange(n_in) - np.repeat(starts, counts)
    table = np.full((n_out, K), n_in, dtype=np.int64)
    table[targets[order], slot] = order
    return table


def segment_sum(vals: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[..., t] = Σ vals[..., i]`` over ``targets[i] == t`` (zero if
    none)."""
    ext = torch.cat([vals, vals.new_zeros(vals.shape[:-1] + (1,))], dim=-1)
    return ext[..., table].sum(dim=-1)


def segment_max(vals: torch.Tensor, table: torch.Tensor, fill: float):
    """``out[..., t] = max(fill, max vals[..., i] over targets[i] == t)``."""
    ext = torch.cat([vals, vals.new_full(vals.shape[:-1] + (1,), fill)], dim=-1)
    return torch.clamp_min(ext[..., table].amax(dim=-1), fill)
