"""General helpers (counterpart of ``terrarium_tpu/utils/utils.py``)."""
from __future__ import annotations

import datetime as _dt
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["safediv", "convert_dt", "merge_recursive", "deduplicate"]


def safediv(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x / (y + eps)`` where ``y != 0``, else ``+inf`` (reference
    `src/utils/utils.jl:25`); ``eps`` is the machine epsilon of the dtype.

    Selected with `torch.where`, so ``x / (0 + eps)`` is evaluated but
    discarded: IEEE products such as ``0 * inf`` never reach the result."""
    eps = torch.finfo(torch.result_type(x, y)).eps
    return torch.where(y == 0, torch.inf, x / (y + eps))


def convert_dt(dt) -> float:
    """Convert a timedelta-like ``dt`` to seconds."""
    if isinstance(dt, _dt.timedelta):
        return dt.total_seconds()
    if isinstance(dt, np.timedelta64):
        return float(dt / np.timedelta64(1, "s"))
    return float(dt)


def merge_recursive(*dicts: Mapping[str, Any]) -> dict:
    """Recursively merge mappings; later arguments take precedence."""
    out: dict = {}
    for d in dicts:
        for k, v in d.items():
            if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
                out[k] = merge_recursive(out[k], v)
            else:
                out[k] = v
    return out


def deduplicate(items, key=lambda x: x):
    """Stable dedup keeping the first occurrence."""
    seen = set()
    out = []
    for it in items:
        k = key(it)
        if k not in seen:
            seen.add(k)
            out.append(it)
    return out
