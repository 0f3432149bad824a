"""Static-exponent powers (counterpart of ``terrarium_tpu/ops/fastpow.py``).

``x ** p`` with a fixed exponent that is a small rational with denominator 1,
2 or 3 becomes a root (none, ``sqrt``, third root) followed by integer
powering by repeated multiplication; any other exponent stays ``x ** p``.
The CUDA column kernel applies the same rule to the code that
:func:`pow_code` returns, so both evaluate the same chain of operations. The
plain version takes third roots through ``pow(x, 1/3)`` (this torch has no
``cbrt``), the kernel through ``cbrt``: they differ by an ulp.
"""
from __future__ import annotations

import torch

__all__ = ["fast_pow", "pow_code"]

_MAX_NUM = 12  # largest numerator expanded into multiplies


def pow_code(p: float):
    """``(num, den)`` such that ``x ** p == root_den(x) ** num``, or
    ``(0, 0)`` when ``p`` has no such form (then ``x ** p`` is used).
    ``p == 0`` is returned as ``(0, 1)``."""
    p = float(p)
    if p == 0.0:
        return 0, 1
    for den in (1, 2, 3):
        num = p * den
        if abs(num - round(num)) < 1e-12 and abs(round(num)) <= _MAX_NUM:
            return int(round(num)), den
    return 0, 0


def _ipow(x, k: int):
    """``x ** k`` for integer ``k != 0`` by binary powering."""
    if k < 0:
        return 1.0 / _ipow(x, -k)
    y = None
    base = x
    while k:
        if k & 1:
            y = base if y is None else y * base
        k >>= 1
        if k:
            base = base * base
    return y


def fast_pow(x: torch.Tensor, p: float) -> torch.Tensor:
    """``x ** p`` for non-negative ``x`` and a fixed exponent ``p``."""
    num, den = pow_code(p)
    if den == 0:
        return x ** float(p)
    if num == 0:
        return torch.ones_like(x)
    if den == 1:
        root = x
    elif den == 2:
        root = torch.sqrt(x)
    else:
        root = x ** (1.0 / 3.0)
    return _ipow(root, num)
