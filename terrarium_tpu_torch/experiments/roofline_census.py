"""The card's per-operation rates (counterpart of
``experiments/roofline_census.py::run_micro``, the Pallas kernel of
``run_micro.make`` at `:260`, called at `:289`).

:func:`micro_chain` runs a chain of ``R`` dependent operations of one kind
on every element of an array: a hand-written CUDA kernel
(``csrc/probes.cu``, ``PROBE_ROW`` 4) on the card, its plain PyTorch version
:func:`micro_chain_plain` on the CPU; each launch adds one to
``micro_chain.launches`` (``probe.count``). The kinds are `:264-285`'s: ``fma`` (v * 1.0000001
+ 1e-7), ``fma4`` (four independent fma chains from x, x + 1, x + 2, x +
3, summed: throughput-bound where one chain is latency-bound), ``exp``
(exp(1e-3 v)), ``div`` (1.00001 / (v + 1.5)) and ``pow`` ((v +
1.5)^0.7071). The kernel is built with the port's own ``nvcc`` flags
(``ops/cuda_build.py``: -O3, no fast-math), so it measures these operations
as the port's kernels emit them.

:func:`run_micro` keeps the JAX measurement's design: the array is f32
``(256, 65,536)`` of ones, 8 chained passes a dispatch, the median of 7
dispatches, and each kind's rate from the difference of two chain lengths
(`:322-326`), which cancels the launch and the array's reads and writes.
It prints one JSON line a kind as `:331-337` does.

    python -m terrarium_tpu_torch.experiments.roofline_census --micro

The JAX file's census (an XLA HLO operation count, no kernel) has no
counterpart here.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

from . import probe

__all__ = ["KINDS", "SHAPE", "PASSES", "micro_chain", "micro_chain_plain", "run_micro"]

#: kind -> (flops an operation, the two chain lengths R of `:322-326`)
KINDS = {"fma": (2.0, (64, 512)), "fma4": (2.0, (64, 256)), "exp": (1.0, (64, 256)),
         "pow": (1.0, (16, 128)), "div": (1.0, (64, 512))}
_CODES = {"fma": 0, "fma4": 1, "exp": 2, "div": 3, "pow": 4}
SHAPE = (256, 65536)  # (256, 512) blocks x 128 (`:257-258`)
PASSES = 8  # chained passes a dispatch (`:298-303`)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def micro_chain_plain(x: torch.Tensor, kind: str, R: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``R`` steps of ``kind``'s
    operation on every element of ``x``, in the kernel's order."""
    if kind not in _CODES:
        raise ValueError(f"kind must be one of {sorted(_CODES)}, not {kind!r}")
    if kind == "fma4":
        vs = [x + float(i) for i in range(4)]
        a = [torch.tensor(1.0000001 + 1e-9 * i, dtype=x.dtype, device=x.device)
             for i in range(4)]
        for _ in range(R):
            vs = [v * a[i] + 1e-7 for i, v in enumerate(vs)]
        return ((vs[0] + vs[1]) + vs[2]) + vs[3]
    v = x
    for _ in range(R):
        if kind == "fma":
            v = v * 1.0000001 + 1e-7
        elif kind == "exp":
            v = torch.exp(v * 1e-3)
        elif kind == "div":  # a division, as the kernel's (scalar / tensor takes a reciprocal)
            v = torch.div(torch.tensor(1.00001, dtype=x.dtype, device=x.device), v + 1.5)
        else:
            v = torch.pow(v + 1.5, 0.7071)
    return v


def micro_chain(x: torch.Tensor, kind: str, R: int) -> torch.Tensor:
    """``R`` steps of ``kind``'s operation on every element of ``x``
    (float32 or float64, contiguous): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU one."""
    if kind not in _CODES:
        raise ValueError(f"kind must be one of {sorted(_CODES)}, not {kind!r}")
    if int(R) != R or R < 0:
        raise ValueError(f"R must be an integer >= 0, got {R!r}")
    if probe.check({"x": x}, x) == "cpu":
        return micro_chain_plain(x, kind, int(R))
    out = torch.empty_like(x)
    fn = probe.entry("micro", x.dtype, 1, _ARGTYPES)
    probe.launch(fn, x.data_ptr(), out.data_ptr(), x.numel(), _CODES[kind], int(R),
                 device=x.device)
    probe.count(micro_chain)
    return out


micro_chain.launches = micro_chain.captured = 0


def _passes(x: torch.Tensor, kind: str, R: int) -> torch.Tensor:
    """``PASSES`` chained passes from ``x`` (`:298-303`)."""
    for _ in range(PASSES):
        x = micro_chain(x, kind, R)
    return x


def run_micro(reps: int = 7, device: str = "cuda") -> dict:
    """Each kind's time at its two chain lengths and its rate, printed as
    one JSON line a kind: ``{kind: {"t_R<r1>_s", "t_R<r2>_s", "ops_per_s",
    "gops_per_s", "gflops_per_s"}}`` (`:320-337`; ops_per_s counts the four
    chains of ``fma4``). Times are CUDA events around one dispatch of
    ``PASSES`` launches, the median of ``reps`` after one warm-up."""
    x = torch.ones(SHAPE, dtype=torch.float32, device=device)
    size = x.numel() * PASSES
    results = {}
    for kind, (flops_per, (r1, r2)) in KINDS.items():
        t1, t2 = (probe.median_ms(lambda r=r: _passes(x, kind, r), reps) / 1e3
                  for r in (r1, r2))
        chains = 4 if kind == "fma4" else 1
        rate = chains * size * (r2 - r1) / max(t2 - t1, 1e-9)
        results[kind] = {f"t_R{r1}_s": t1, f"t_R{r2}_s": t2, "ops_per_s": rate,
                         "gops_per_s": rate / 1e9, "gflops_per_s": flops_per * rate / 1e9}
        print(json.dumps({kind: results[kind]}), flush=True)
    return results


if __name__ == "__main__":
    if "--micro" not in sys.argv:
        raise SystemExit("usage: python -m terrarium_tpu_torch.experiments.roofline_census "
                         "--micro (the JAX file's HLO census has no counterpart here)")
    run_micro()
