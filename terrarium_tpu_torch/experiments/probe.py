"""What the probe wrappers share: their source's entry point, the checks
of their operands, their launch counts and the CUDA-event timing of their
entry points."""
from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build

_NAME = "probes"  # csrc/probes.cu


def entry(tag: str, dtype: torch.dtype, nz: int, argtypes):
    """The probe ``tag``'s entry point of ``csrc/probes.cu`` at ``dtype``
    and depth ``nz``."""
    return cuda_build.entry(_NAME, dtype, nz, argtypes + [ctypes.c_void_p], tags=(tag,))


def check(tensors: dict, like: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"``: where the probe runs, after checking that
    every tensor of ``tensors`` (name -> tensor) has ``like``'s dtype and
    device and is contiguous. Raises ``TypeError`` for another dtype than
    float32 or float64, ``ValueError`` otherwise."""
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the probes take float32 or float64, not {like.dtype}")
    for name, t in tensors.items():
        if t.dtype != like.dtype or t.device != like.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, expected {like.dtype} on "
                             f"{like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if like.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the probes run on cpu or cuda, not {like.device}")
    return like.device.type


def launch(fn, *args, device: torch.device) -> None:
    """Call the entry point ``fn`` on the current stream of ``device`` and
    raise on a launch error."""
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: cudaError {err}")


def count(wrapper) -> None:
    """Count one call of ``wrapper`` that put its kernel on the stream: one
    launch, added to ``wrapper.launches``; inside a CUDA graph's capture,
    which launches nothing, it is added to ``wrapper.captured`` instead, and
    each replay of the graph adds what its capture counted to ``launches``
    (:func:`graph_ms`)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def median_ms(fn, reps: int) -> float:
    """The median CUDA-event time of ``reps`` calls of ``fn()``, each timed
    alone, after one untimed call, in ms."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def graph_ms(fn, reps: int, replays: int = 5, counted=()) -> float:
    """The device time of one call of ``fn()`` in ms: ``reps`` calls
    captured in a CUDA graph, each replay timed with CUDA events and
    divided by ``reps``, the median of ``replays``. A kernel of a few
    microseconds timed alone measures its caller's host work instead. Each
    replay adds to the ``launches`` of each wrapper in ``counted`` the
    launches its capture counted (:func:`count`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs ask
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = [w.captured for w in counted]
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    captured = [w.captured - b for w, b in zip(counted, before)]
    times = []
    for _ in range(replays):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        for w, n in zip(counted, captured):
            w.launches += n
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]
