"""Build and load the port's CUDA sources.

Each kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``_build/<name>-<hash>.so`` beside the package; the hash covers the source and
every header in ``csrc/``. A source defines one entry point per
instantiation, ``<name>[_<tag>...]_<f32|f64>_nz<NZ>``, from the list of that
source in ``INSTANTIATIONS``; each instantiation is compiled by its own
``nvcc`` (``-DSOIL_ENTRY -DSOIL_T -DSOIL_NZ`` and the tags'
defines, ``_DEFINES``), all of them and all the sources asked for together in parallel,
and linked into the source's library. ptxas's register and spill report is
kept beside the library as ``.ptxas.txt``, each instantiation's part headed
by a line ``== <entry point>`` and a line ``cpu_s <seconds>``, the CPU time
its ``nvcc`` (and the compilers it ran) took. At most one ``nvcc`` runs per
core the process may use; builds of different sources asked for from
different threads share those slots, in the order they asked.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = ["build", "ptxas_report", "entry", "INSTANTIATIONS"]

_F32, _F64 = torch.float32, torch.float64
#: the ImplicitEuler instantiations that take the Picard count and the
#: solver at run time (picard_step), over heat only and heat + Richards:
#: float32 Nz 30, the timed path, and float64 Nz 16, the checks against the
#: plain version
_PICARD = [(("implicit", "picard", physics), dtype, nz) for physics in ("richards", "heat")
           for dtype, nz in ((_F32, 30), (_F64, 16))]
#: the instantiations of each source, ``(tags, dtype, NZ)``: every one that
#: the port's paths, ``chip_smoke.py`` and the CUDA tests launch (the bench
#: and gradient grids at Nz 20 and 30, the Heun golden at Nz 15, the
#: implicit golden and the float64 checks of the heat-only Heun and of the
#: Picard entries at Nz 16); a launch of any other raises. The costliest to
#: compile come first in each list (the Picard entries), so that they start
#: first in the build's slots
INSTANTIATIONS = {
    "soil_column_rollout": [
        *_PICARD,
        *((("euler", "richards"), dtype, nz) for dtype in (_F32, _F64) for nz in (20, 30)),
        (("heun", "richards"), _F64, 15), (("heun", "richards"), _F32, 30),
        (("euler", "heat"), _F32, 30), (("euler", "heat"), _F64, 30),
        *((("implicit", solver, "richards"), dtype, nz) for solver in ("thomas", "pcr")
          for dtype, nz in ((_F64, 16), (_F32, 30))),
        (("heun", "heat"), _F32, 30), (("heun", "heat"), _F64, 16),
    ],
    # ForwardEuler over heat + Richards (no tags) at the gradient grids; each
    # other scheme at its forward kernel's sizes: Heun f64 Nz 15 and f32 Nz
    # 30, ImplicitEuler f64 Nz 16 and f32 Nz 30, heat-only ForwardEuler Nz
    # 30, heat-only Heun f64 Nz 16 and f32 Nz 30, the Picard entries
    "soil_column_segment_vjp": [
        *_PICARD,
        *(((), dtype, nz) for dtype in (_F32, _F64) for nz in (20, 30)),
        (("heun", "richards"), _F64, 15), (("heun", "richards"), _F32, 30),
        *((("implicit", solver, "richards"), dtype, nz) for solver in ("thomas", "pcr")
          for dtype, nz in ((_F64, 16), (_F32, 30))),
        (("euler", "heat"), _F64, 30), (("euler", "heat"), _F32, 30),
        (("heun", "heat"), _F64, 16), (("heun", "heat"), _F32, 30),
    ],
    # one full step (make_fused_step): the bench width at float32 for each
    # stepper and physics, and the float64 checks against the plain version
    "soil_column_full_step": [
        (("euler", "richards"), _F32, 30), (("euler", "richards"), _F64, 20),
        (("euler", "heat"), _F32, 30), (("heun", "heat"), _F32, 30),
        (("heun", "richards"), _F64, 15), (("heun", "richards"), _F32, 30),
    ],
    # the LandModel: ForwardEuler over the bare-ground golden at Nz 15
    # (heat-only soil) and over the vegetated bench composition (Richards over
    # Brooks-Corey and linear conductivity) at Nz 20; Heun and ImplicitEuler
    # (each solver) over the bench composition at Nz 20; the snowpack over the
    # land_snow golden's composition (bare ground, Brooks-Corey and linear) at
    # Nz 12 with ForwardEuler and over the bench composition at Nz 20 with
    # ImplicitEuler (PCR)
    "land_column_rollout": [
        (("bare", "noflow"), _F64, 15),
        *((("veg", "richards", "bc", "linear"), dtype, 20) for dtype in (_F32, _F64)),
        *((("heun", "veg", "richards", "bc", "linear"), dtype, 20) for dtype in (_F32, _F64)),
        *((("implicit", solver, "veg", "richards", "bc", "linear"), dtype, 20)
          for solver in ("thomas", "pcr") for dtype in (_F32, _F64)),
        (("bare", "richards", "bc", "linear", "snow"), _F64, 12),
        *((("implicit", "pcr", "veg", "richards", "bc", "linear", "snow"), dtype, 20)
          for dtype in (_F32, _F64)),
    ],
    # the LandModel's segment VJP over the vegetated bench composition
    # (Richards over Brooks-Corey and linear conductivity) at Nz 20:
    # ForwardEuler and ImplicitEuler (each solver)
    "land_column_segment_vjp": [
        ((*stepper, "veg", "richards", "bc", "linear"), dtype, 20)
        for stepper in ((), ("implicit", "thomas"), ("implicit", "pcr"))
        for dtype in (_F32, _F64)
    ],
}
_DEFINES = {"euler": ("SOIL_STEPPER=0",), "heun": ("SOIL_STEPPER=1",),
            "implicit": ("SOIL_STEPPER=2",), "thomas": ("SOIL_SOLVER=0",),
            "pcr": ("SOIL_SOLVER=1",), "picard": ("SOIL_PICARD=1", "SOIL_SOLVER=2"), "richards": ("SOIL_HEAT=0", "LAND_RICHARDS=1"),
            "heat": ("SOIL_HEAT=1",), "noflow": ("LAND_RICHARDS=0",), "bare": ("LAND_VEG=0",),
            "veg": ("LAND_VEG=1",), "vg": ("LAND_CURVE=0",), "bc": ("LAND_CURVE=1",),
            "mualem": ("LAND_COND=0",), "linear": ("LAND_COND=1",), "snow": ("LAND_SNOW=1",)}
#: nvcc flags of a source's instantiations of one dtype beyond the common
#: ones: the land kernels' float64 instantiations, which serve the checks
#: against the plain version at 1e-12 (the VJP's at 1e-9), contract no
#: multiply-adds (torch's elementwise ops do not), while their float32
#: ones, the timed path, do
FLAGS = {"land_column_rollout": {_F64: ("-fmad=false",)},
         "land_column_segment_vjp": {_F64: ("-fmad=false",)}}
_SUFFIX = {_F32: ("f32", "float"), _F64: ("f64", "double")}
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

_libs: dict = {}
_lock = threading.Lock()  # guards _source_locks
_source_locks: dict = {}
_slots = threading.Semaphore(len(os.sched_getaffinity(0)))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
                           "built from terrarium_tpu_torch/csrc at first use")
    return found


def _stem(name: str) -> str:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(repr(sorted((str(d), f) for d, f in FLAGS.get(name, {}).items())).encode())
    return f"{name}-{h.hexdigest()[:12]}"


def _run(cmd, out: list, i: int) -> None:
    """Run ``cmd`` in a free slot; ``out[i] = (returncode, stderr, cpu
    seconds)``."""
    with _slots:
        p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        err = p.stderr.read()
        p.stderr.close()
        _, status, usage = os.wait4(p.pid, 0)
        out[i] = (os.waitstatus_to_exitcode(status), err, usage.ru_utime + usage.ru_stime)


def _run_all(cmds):
    """Run the commands in parallel, each in a slot, in their order;
    ``[(returncode, stderr, cpu seconds), ...]``."""
    out = [None] * len(cmds)
    threads = [threading.Thread(target=_run, args=(c, out, i)) for i, c in enumerate(cmds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def build(*names: str) -> list:
    """The loaded libraries of ``csrc/<name>.cu`` for each of ``names``,
    compiling (in parallel) those not built yet. A source that another
    thread is building is waited for."""
    with _lock:
        locks = [_source_locks.setdefault(n, threading.Lock()) for n in sorted(set(names))]
    for lock in locks:  # in sorted order, so that two builds cannot deadlock
        lock.acquire()
    try:
        todo = [n for n in names if n not in _libs]
        stems = {n: _stem(n) for n in todo}
        missing = [n for n in todo if not (_BUILD_DIR / f"{stems[n]}.so").exists()]
        if missing:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                nvcc, jobs = _nvcc(), []
                for n in missing:
                    for tags, dtype, nz in INSTANTIATIONS[n]:
                        ctype = _SUFFIX[dtype][1]
                        name = _entry_name(n, tags, dtype, nz)
                        obj = pathlib.Path(tmp) / f"{name}.o"
                        jobs.append((n, name, obj, [
                            nvcc, *_ARCH, "-std=c++17", "-O3", *FLAGS.get(n, {}).get(dtype, ()),
                            "-Xcompiler", "-fPIC",
                            "-Xptxas", "-v", f"-DSOIL_ENTRY={name}",
                            f"-DSOIL_T={ctype}", f"-DSOIL_NZ={nz}",
                            *(f"-D{d}" for t in tags for d in _DEFINES[t]), "-c", "-o", str(obj),
                            str(_CSRC / f"{n}.cu")]))
                results = _run_all([cmd for *_, cmd in jobs])
                failed = [f"{obj.name}: nvcc exit {rc}\n{err}"
                          for (_, _, obj, _), (rc, err, _) in zip(jobs, results) if rc != 0]
                if failed:
                    raise RuntimeError("\n".join(failed))
                links = [[nvcc, *_ARCH, "-shared", "-o", str(pathlib.Path(tmp) / f"{stems[n]}.so"),
                          *(str(obj) for m, _, obj, _ in jobs if m == n)]
                         for n in missing]
                failed = [f"{n}: link exit {rc}\n{err}"
                          for n, (rc, err, _) in zip(missing, _run_all(links)) if rc != 0]
                if failed:
                    raise RuntimeError("\n".join(failed))
                for n in missing:
                    report = "".join(f"== {name}\ncpu_s {cpu:.1f}\n{err}"
                                     for (m, name, _, _), (_, err, cpu) in zip(jobs, results)
                                     if m == n)
                    (_BUILD_DIR / f"{stems[n]}.ptxas.txt").write_text(report)
                    os.replace(pathlib.Path(tmp) / f"{stems[n]}.so",
                               _BUILD_DIR / f"{stems[n]}.so")
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_BUILD_DIR / f"{stems[n]}.so"))
        return [_libs[n] for n in names]
    finally:
        for lock in locks:
            lock.release()


def _entry_name(name: str, tags, dtype: torch.dtype, nz: int) -> str:
    return "_".join((name, *tags, _SUFFIX[dtype][0], f"nz{nz}"))


def entry(name: str, dtype: torch.dtype, nz: int, argtypes, tags=()):
    """The entry point ``<name>[_<tag>...]_<f32|f64>_nz<NZ>`` of
    ``csrc/<name>.cu``'s library (built at first use), typed with
    ``argtypes`` and an int result (the launch's CUDA error code). Raises
    ``ValueError`` naming the built instantiations for any other."""
    tags = tuple(tags)
    if (tags, dtype, nz) not in INSTANTIATIONS[name]:
        built = ", ".join(f"{'/'.join(t) + ' ' if t else ''}{_SUFFIX[d][0]} Nz {z}"
                          for t, d, z in INSTANTIATIONS[name])
        raise ValueError(f"{name} is not built for {'/'.join(tags) + ' ' if tags else ''}"
                         f"{_SUFFIX.get(dtype, (dtype,))[0]} Nz {nz}; built: {built}")
    fn = getattr(build(name)[0], _entry_name(name, tags, dtype, nz))
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptxas_report(name: str) -> str:
    """ptxas's ``-v`` output of the current build of ``csrc/<name>.cu`` ('' before
    the build)."""
    path = _BUILD_DIR / f"{_stem(name)}.ptxas.txt"
    return path.read_text() if path.exists() else ""
