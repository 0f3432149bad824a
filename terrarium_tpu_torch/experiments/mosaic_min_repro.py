"""The Mosaic ``layout.h:320`` repro variants on the card (counterpart of
``experiments/mosaic_min_repro.py::run_variant``, the Pallas call at
`:93`).

:func:`repro_variant` runs ``inner`` iterations of one variant's body
(``_kernel_factory(variant)``, `:29-66`) over ``T`` ``(nz, cols)`` and
``s`` ``(cols,)``: a hand-written CUDA kernel (``csrc/probes.cu``,
``PROBE_ROW`` 6; one thread a column, T's levels and s in registers) on the
card, its plain PyTorch version :func:`repro_variant_plain` on the CPU;
each launch adds one to ``repro_variant.launches``. The variants:
``xy_only`` (s from itself), ``row_to_xy`` and ``row_to_xy_masksum`` (s
from T's top row, by a slice or by a masked sum: the same values),
``row_to_xy_branch`` (the two-branch Magnus exponential of the top row) and
``row_to_xy_stencil`` (T also updated by the zero-filled z-stencil, its
shifts from the port's own vertical operators,
``ops/vertical_ops.face_operands``).

:func:`run_variant` runs the probe's shapes (`:26`, `:72-97`: T ones ``(8,
256)``, s zeros ``(1, 256)``, 4 iterations, float32), holds the kernel to
the plain version and on the card times it (100 launches), printing one
JSON line.

    python -m terrarium_tpu_torch.experiments.mosaic_min_repro [variant]

On the TPU these kernels reproduced a Mosaic compiler crash. On Hopper they
are tiny correct kernels whose time is the launch latency.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

from . import probe
from ..ops.vertical_ops import face_operands

__all__ = ["VARIANTS", "NZ", "BLOCK", "INNER", "repro_variant", "repro_variant_plain",
           "run_variant"]

VARIANTS = ["xy_only", "row_to_xy", "row_to_xy_masksum", "row_to_xy_branch",
            "row_to_xy_stencil"]
NZ, BLOCK, INNER = 8, 256, 4
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]


def _body(variant: str, T: torch.Tensor, s: torch.Tensor):
    """One iteration of ``_kernel_factory(variant)``'s body (`:29-66`)."""
    gt = T[-1]
    if variant == "xy_only":
        return T * 0.999, 0.5 * s + torch.exp(0.01 * s)
    if variant in ("row_to_xy", "row_to_xy_masksum"):
        return T * 0.999, 0.5 * s + torch.exp(0.01 * gt)
    if variant == "row_to_xy_branch":
        e = torch.where(gt <= 0.0, 611.0 * torch.exp(22.46 * gt / (gt + 272.62)),
                        611.0 * torch.exp(17.62 * gt / (gt + 243.12)))
        return T * 0.999, 0.5 * s + 1e-4 * e
    if variant == "row_to_xy_stencil":
        zero = torch.zeros_like(T[:1])
        upper, lower = face_operands(T, zero, zero)  # T[k] and T[k - 1] at face k
        return T + 0.01 * ((upper[1:] + lower[:-1]) - 2.0 * T), 0.5 * s + torch.exp(0.01 * gt)
    raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")


def repro_variant_plain(variant: str, T: torch.Tensor, s: torch.Tensor, inner: int = INNER):
    """Plain PyTorch version of the kernel: ``(T, s)`` after ``inner``
    iterations of the variant's body."""
    for _ in range(inner):
        T, s = _body(variant, T, s)
    return T, s


def repro_variant(variant: str, T: torch.Tensor, s: torch.Tensor, inner: int = INNER):
    """``(T, s)`` after ``inner`` iterations of the variant's body, ``T``
    ``(nz, cols)`` and ``s`` ``(cols,)`` (float32 or float64, contiguous):
    the CUDA kernel on CUDA tensors, the plain version on CPU ones."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    if T.dim() != 2 or tuple(s.shape) != (T.shape[1],):
        raise ValueError(f"T must be (nz, cols) and s (cols,), got {tuple(T.shape)} and "
                         f"{tuple(s.shape)}")
    if int(inner) != inner or inner < 0:
        raise ValueError(f"inner must be an integer >= 0, got {inner!r}")
    if probe.check({"T": T, "s": s}, T) == "cpu":
        return repro_variant_plain(variant, T, s, int(inner))
    T_out, s_out = torch.empty_like(T), torch.empty_like(s)
    fn = probe.entry("repro", T.dtype, T.shape[0], _ARGTYPES)
    probe.launch(fn, T.data_ptr(), s.data_ptr(), T_out.data_ptr(), s_out.data_ptr(),
                 T.shape[1], VARIANTS.index(variant), int(inner), device=T.device)
    probe.count(repro_variant)
    return T_out, s_out


repro_variant.launches = repro_variant.captured = 0


def run_variant(variant: str, device: str = "cuda", reps: int = 100) -> dict:
    """The variant at the probe's shapes, float32: ``{"variant", "status",
    "finite", "max_abs_err"}`` against the plain version and, on the card,
    ``"ms"``, a launch's device time (``reps`` launches in a CUDA graph, the
    median of 5 replays) and ``"call_ms"``, the median of ``reps`` calls each
    timed alone (the wrapper's host work included); printed as one JSON
    line."""
    T = torch.ones((NZ, BLOCK), dtype=torch.float32, device=device)
    s = torch.zeros(BLOCK, dtype=torch.float32, device=device)
    T_k, s_k = repro_variant(variant, T, s)
    T_p, s_p = repro_variant_plain(variant, T, s)
    err = max(float((T_k - T_p).abs().max()), float((s_k - s_p).abs().max()))
    res = {"variant": variant, "status": "ok", "finite": bool(torch.isfinite(s_k).all()),
           "max_abs_err": err}
    if T.device.type == "cuda":
        res["ms"] = probe.graph_ms(lambda: repro_variant(variant, T, s), reps,
                                   counted=(repro_variant,))
        res["call_ms"] = probe.median_ms(lambda: repro_variant(variant, T, s), reps)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    for v in sys.argv[1:] or VARIANTS:
        run_variant(v)
