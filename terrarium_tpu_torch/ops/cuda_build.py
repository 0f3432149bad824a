"""Build and load the port's CUDA sources.

Each kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use, into
``_build/<name>-<hash>.so`` beside the package; the hash covers the source and
every header in ``csrc/``. A source defines one entry point
``<name>_<f32|f64>_nz<NZ>`` per instantiation; each instantiation is
compiled by its own ``nvcc`` (``-DSOIL_SUFFIX -DSOIL_T -DSOIL_NZ``), all of
them and all the sources asked for together in parallel, and linked into the
source's library. ptxas's register and spill report is kept beside the
library as ``.ptxas.txt``.
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

__all__ = ["build", "ptxas_report", "entry", "SUPPORTED_NZ"]

#: vertical sizes the kernels are instantiated for (the golden, bench and
#: gradient grids)
SUPPORTED_NZ = (20, 30)
_VARIANTS = [(suffix, ctype, nz) for suffix, ctype in (("f32", "float"), ("f64", "double"))
             for nz in SUPPORTED_NZ]
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

_libs: dict = {}
_lock = threading.Lock()


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
    return f"{name}-{h.hexdigest()[:12]}"


def _run_all(cmds):
    """Run the commands in parallel; ``[(returncode, stderr), ...]``."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    for p in procs:
        _, err = p.communicate()
        out.append((p.returncode, err))
    return out


def build(*names: str) -> list:
    """The loaded libraries of ``csrc/<name>.cu`` for each of ``names``,
    compiling (in parallel) those not built yet."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        stems = {n: _stem(n) for n in todo}
        missing = [n for n in todo if not (_BUILD_DIR / f"{stems[n]}.so").exists()]
        if missing:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                nvcc, jobs = _nvcc(), []
                for n in missing:
                    for suffix, ctype, nz in _VARIANTS:
                        obj = pathlib.Path(tmp) / f"{n}_{suffix}_nz{nz}.o"
                        jobs.append((n, obj, [
                            nvcc, *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                            "-Xptxas", "-v", f"-DSOIL_SUFFIX={suffix}", f"-DSOIL_T={ctype}",
                            f"-DSOIL_NZ={nz}", "-c", "-o", str(obj), str(_CSRC / f"{n}.cu")]))
                results = _run_all([cmd for _, _, cmd in jobs])
                failed = [f"{obj.name}: nvcc exit {rc}\n{err}"
                          for (_, obj, _), (rc, err) in zip(jobs, results) if rc != 0]
                if failed:
                    raise RuntimeError("\n".join(failed))
                links = [[nvcc, *_ARCH, "-shared", "-o", str(pathlib.Path(tmp) / f"{stems[n]}.so"),
                          *(str(obj) for m, obj, _ in jobs if m == n)]
                         for n in missing]
                failed = [f"{n}: link exit {rc}\n{err}"
                          for n, (rc, err) in zip(missing, _run_all(links)) if rc != 0]
                if failed:
                    raise RuntimeError("\n".join(failed))
                for n in missing:
                    report = "".join(err for (m, _, _), (_, err) in zip(jobs, results) if m == n)
                    (_BUILD_DIR / f"{stems[n]}.ptxas.txt").write_text(report)
                    os.replace(pathlib.Path(tmp) / f"{stems[n]}.so",
                               _BUILD_DIR / f"{stems[n]}.so")
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_BUILD_DIR / f"{stems[n]}.so"))
        return [_libs[n] for n in names]


def entry(name: str, dtype: torch.dtype, nz: int, argtypes):
    """The entry point ``<name>_<f32|f64>_nz<NZ>`` of ``csrc/<name>.cu``'s
    library (built at first use), typed with ``argtypes`` and an int result
    (the launch's CUDA error code)."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(build(name)[0], f"{name}_{suffix}_nz{nz}")
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptxas_report(name: str) -> str:
    """ptxas's ``-v`` output of the current build of ``csrc/<name>.cu`` ('' before
    the build)."""
    path = _BUILD_DIR / f"{_stem(name)}.ptxas.txt"
    return path.read_text() if path.exists() else ""
