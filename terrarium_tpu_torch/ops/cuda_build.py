"""Build and load the port's CUDA sources.

Each kernel source ``csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, at first use,
beside the package in ``_build/``, under the stem ``<name>-<hash>``; the hash
covers the source, every header in ``csrc/`` and the source's extra flags.
A source defines one entry point per instantiation,
``<name>[_<tag>...]_<f32|f64>_nz<NZ>``, each compiled by its own ``nvcc``
(``-DSOIL_ENTRY -DSOIL_T -DSOIL_NZ`` and the tags' defines, ``_DEFINES``;
``FLAGS``). Two kinds:

* the prebuilt set, the list of that source in ``INSTANTIATIONS``: the
  first launch of any of them compiles all of them, and all the sources
  asked for together, in parallel, and links them into the source's
  library ``<stem>.so``;
* every other instantiation (``entry``): compiled alone at its own first
  launch into ``<stem>-<entry point>.so``, with the same defines and flags
  as a listed one, under a lock of its own, so that the card runs every
  composition the port's type checks send to a kernel at any dtype (f32 or
  f64) and depth.

ptxas's register and spill report is kept beside each library as
``.ptxas.txt``, each instantiation's part headed by a line ``== <entry
point>`` and a line ``cpu_s <seconds>``, the CPU time its ``nvcc`` (and the
compilers it ran) took. At most one compiling ``nvcc`` runs per core the
process may use; builds asked for from different threads share those slots,
in the order they asked, and each library's link runs as soon as its
objects are compiled.
"""
from __future__ import annotations

import contextlib
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
#: the prebuilt instantiations of each source, ``(tags, dtype, NZ)``, built
#: together at the source's first launch: those that ``chip_smoke.py``'s
#: timed and checked paths launch (the bench and gradient grids at Nz 20 and
#: 30, the Heun golden at Nz 15, the implicit golden and the float64 checks
#: of the heat-only Heun, of the Picard entries and of ImplicitEuler's full
#: step at Nz 16). Any other is built alone at its first launch (``entry``).
#: Each list is in the order of its instantiations' compile cost, costliest
#: first (nvcc CPU seconds on the card's machine, the ``cpu_s`` lines of the
#: ptxas reports), so that the longest compiles start first in the build's
#: slots and a source's build ends with short ones
INSTANTIATIONS = {
    # ForwardEuler, Heun and ImplicitEuler over heat + Richards, a column on
    # a group of lanes: the bench and gradient grids at Nz 30 and 20 (each
    # explicit stepper's float64 check at Nz 30), the Heun golden at Nz 15;
    # ImplicitEuler (each solver, and the Picard entries, which hold a
    # kernel of each solver) at the bench width and, for the implicit golden
    # and the float64 checks, at Nz 16
    "soil_column_group_rollout": [
        (("implicit", "picard", "richards"), _F32, 30),
        (("implicit", "picard", "richards"), _F64, 16),
        (("implicit", "pcr", "richards"), _F32, 30),
        (("implicit", "thomas", "richards"), _F32, 30),
        (("implicit", "pcr", "richards"), _F64, 16),
        (("implicit", "thomas", "richards"), _F64, 16),
        (("heun", "richards"), _F64, 15), (("euler", "richards"), _F64, 20),
        (("heun", "richards"), _F64, 30), (("euler", "richards"), _F32, 20),
        (("heun", "richards"), _F32, 30), (("euler", "richards"), _F64, 30),
        (("euler", "richards"), _F32, 30),
    ],
    # every other soil rollout, a column a thread: the heat-only model
    # (ImplicitEuler's heat + Richards entries stay buildable on demand, to
    # time the one-thread layout against the group's)
    "soil_column_rollout": [
        (("implicit", "picard", "heat"), _F32, 30), (("implicit", "picard", "heat"), _F64, 16),
        (("heun", "heat"), _F32, 30), (("heun", "heat"), _F64, 16), (("euler", "heat"), _F64, 30),
        (("euler", "heat"), _F32, 30),
    ],
    # ForwardEuler over heat + Richards (no tags) at the gradient grids; each
    # other scheme at its forward kernel's sizes: Heun f64 Nz 15 and f32 Nz
    # 30, heat-only ForwardEuler Nz 30, heat-only Heun f64 Nz 16 and f32 Nz
    # 30, the heat-only Picard entries (ImplicitEuler's heat + Richards
    # entries stay buildable on demand, to time the one-thread layout
    # against the group's)
    "soil_column_segment_vjp": [
        (("heun", "richards"), _F32, 30), ((), _F64, 30), (("heun", "richards"), _F64, 15),
        ((), _F32, 30), ((), _F64, 20), ((), _F32, 20),
        (("implicit", "picard", "heat"), _F32, 30), (("implicit", "picard", "heat"), _F64, 16),
        (("heun", "heat"), _F32, 30), (("euler", "heat"), _F64, 30),
        (("euler", "heat"), _F32, 30), (("heun", "heat"), _F64, 16),
    ],
    # ImplicitEuler over heat + Richards, a column on a group of lanes: each
    # solver and the Picard entries (which hold a kernel of each solver) at
    # the gradient's float32 Nz 30 and the float64 checks' Nz 16
    "soil_column_group_segment_vjp": [
        (("implicit", "picard", "richards"), _F64, 16),
        (("implicit", "picard", "richards"), _F32, 30),
        (("implicit", "thomas", "richards"), _F64, 16),
        (("implicit", "pcr", "richards"), _F64, 16),
        (("implicit", "thomas", "richards"), _F32, 30),
        (("implicit", "pcr", "richards"), _F32, 30),
    ],
    # one full step (make_fused_step): the bench width at float32 for each
    # stepper and physics, and the float64 checks against the plain version;
    # ImplicitEuler (the solver and the Picard count at run time) over heat +
    # Richards and over heat only, each at the bench width and, for its
    # float64 check, at Nz 16
    "soil_column_full_step": [
        (("implicit", "richards"), _F32, 30), (("implicit", "richards"), _F64, 16),
        (("heun", "richards"), _F32, 30), (("heun", "richards"), _F64, 15),
        (("implicit", "heat"), _F32, 30), (("implicit", "heat"), _F64, 16),
        (("euler", "richards"), _F64, 20),
        (("euler", "richards"), _F32, 30), (("heun", "heat"), _F32, 30),
        (("euler", "heat"), _F32, 30),
    ],
    # the LandModel's full step over the vegetated bench composition
    # (Richards over Brooks-Corey and linear conductivity) at Nz 20, float32
    # (timed) and float64 (the checks): ImplicitEuler with the solver and
    # the Picard count at run time, with and without a snowpack, Heun and
    # ForwardEuler
    "land_column_full_step": [
        (("implicit", "veg", "richards", "bc", "linear", "snow"), _F64, 20),
        (("implicit", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "veg", "richards", "bc", "linear", "snow"), _F32, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F64, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F32, 20),
        (("veg", "richards", "bc", "linear"), _F64, 20),
        (("veg", "richards", "bc", "linear"), _F32, 20),
    ],
    # the LandModel: ImplicitEuler with any number of Picard iterations (the
    # solver at run time) over the vegetated bench composition (Richards over
    # Brooks-Corey and linear conductivity) at Nz 20; ForwardEuler over the
    # bare-ground golden at Nz 15 (heat-only soil) and over the bench
    # composition at Nz 20; Heun and ImplicitEuler (each solver) over the
    # bench composition at Nz 20; the snowpack over the land_snow golden's
    # composition (bare ground, Brooks-Corey and linear) at Nz 12 with
    # ForwardEuler and over the bench composition at Nz 20 with ImplicitEuler
    # (PCR)
    "land_column_rollout": [
        (("implicit", "picard", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear", "snow"), _F64, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "picard", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "thomas", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear", "snow"), _F32, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "thomas", "veg", "richards", "bc", "linear"), _F32, 20),
        (("veg", "richards", "bc", "linear"), _F64, 20),
        (("veg", "richards", "bc", "linear"), _F32, 20),
        (("bare", "richards", "bc", "linear", "snow"), _F64, 12), (("bare", "noflow"), _F64, 15),
    ],
    # the LandModel's segment VJP over the vegetated bench composition
    # (Richards over Brooks-Corey and linear conductivity) at Nz 20, one
    # thread a column: ImplicitEuler PCR with a snowpack, Heun and
    # ForwardEuler (ImplicitEuler's entries without a snowpack stay
    # buildable on demand, to time the one-thread layout against the
    # group's)
    "land_column_segment_vjp": [
        (("implicit", "pcr", "veg", "richards", "bc", "linear", "snow"), _F64, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear", "snow"), _F32, 20),
        (("heun", "veg", "richards", "bc", "linear"), _F32, 20),
        (("veg", "richards", "bc", "linear"), _F64, 20),
        (("veg", "richards", "bc", "linear"), _F32, 20),
    ],
    # the LandModel's ImplicitEuler segment VJP over the vegetated bench
    # composition at Nz 20, a column on a group of lanes: each solver and
    # the Picard entries (which hold a kernel of each solver), at float32
    # (the gradient) and float64 (the checks)
    "land_column_group_segment_vjp": [
        (("implicit", "picard", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "thomas", "veg", "richards", "bc", "linear"), _F64, 20),
        (("implicit", "picard", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "thomas", "veg", "richards", "bc", "linear"), _F32, 20),
        (("implicit", "pcr", "veg", "richards", "bc", "linear"), _F32, 20),
    ],
    # the probes (csrc/probes.cu): the roofline micro-benchmark's chains
    # (NZ unused), the Mosaic bisect's cases at its Nz 30 and the Mosaic
    # repro's variants at its Nz 8, each at float32 (timed) and float64
    # (checked)
    "probes": [
        (("bisect",), _F32, 30), (("bisect",), _F64, 30), (("micro",), _F32, 1),
        (("micro",), _F64, 1), (("repro",), _F32, 8), (("repro",), _F64, 8),
    ],
}
_DEFINES = {"euler": ("SOIL_STEPPER=0",), "heun": ("SOIL_STEPPER=1",),
            "implicit": ("SOIL_STEPPER=2",), "thomas": ("SOIL_SOLVER=0",),
            "pcr": ("SOIL_SOLVER=1",), "picard": ("SOIL_PICARD=1", "SOIL_SOLVER=2"), "richards": ("SOIL_HEAT=0", "LAND_RICHARDS=1"),
            "heat": ("SOIL_HEAT=1",), "noflow": ("LAND_RICHARDS=0",), "bare": ("LAND_VEG=0",),
            "veg": ("LAND_VEG=1",), "vg": ("LAND_CURVE=0",), "bc": ("LAND_CURVE=1",),
            "mualem": ("LAND_COND=0",), "linear": ("LAND_COND=1",), "snow": ("LAND_SNOW=1",),
            "micro": ("PROBE_ROW=4",), "bisect": ("PROBE_ROW=5",), "repro": ("PROBE_ROW=6",),
            # the group kernels at a group size other than their depth's
            # (soil::group_lanes, land::implicit_group_lanes) and the group
            # segment VJPs at another launch bound (resident blocks an SM),
            # for measuring one against another
            **{f"g{g}": (f"SOIL_GROUP={g}",) for g in (4, 8, 16, 32)},
            **{f"mb{b}": (f"SOIL_MIN_BLOCKS={b}",) for b in (1, 2, 3, 4)}}
#: nvcc flags of a source's instantiations of one dtype beyond the common
#: ones: the land kernels' float64 instantiations, which serve the checks
#: against the plain version at 1e-12 (the VJP's at 1e-9), contract no
#: multiply-adds (torch's elementwise ops do not), while their float32
#: ones, the timed path, do; so do the probes' float64 instantiations
FLAGS = {"land_column_rollout": {_F64: ("-fmad=false",)},
         "land_column_segment_vjp": {_F64: ("-fmad=false",)},
         "land_column_group_segment_vjp": {_F64: ("-fmad=false",)},
         "land_column_full_step": {_F64: ("-fmad=false",)},
         "probes": {_F64: ("-fmad=false",)}}
_SUFFIX = {_F32: ("f32", "float"), _F64: ("f64", "double")}
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

_libs: dict = {}  # source name, or (source name, entry point) of one built alone
_lock = threading.Lock()  # guards _source_locks
_source_locks: dict = {}  # a lock per source, and per instantiation built alone
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


def _run(cmd, out: list, i: int, gate) -> None:
    """Run ``cmd`` once it holds ``gate``; ``out[i] = (returncode, stderr,
    cpu seconds)``."""
    with gate:
        p = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        err = p.stderr.read()
        p.stderr.close()
        _, status, usage = os.wait4(p.pid, 0)
        out[i] = (os.waitstatus_to_exitcode(status), err, usage.ru_utime + usage.ru_stime)


def _run_all(cmds, slotted: bool = True):
    """Run the commands in parallel, each in a slot (``slotted``; the
    links, which take seconds, at once, so that a library does not wait for
    other builds' compiles), in their order; ``[(returncode, stderr, cpu
    seconds), ...]``."""
    gate = _slots if slotted else contextlib.nullcontext()
    out = [None] * len(cmds)
    threads = [threading.Thread(target=_run, args=(c, out, i, gate))
               for i, c in enumerate(cmds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _make(libs) -> None:
    """Compile and link ``libs``, ``[(stem, source, [(tags, dtype, NZ),
    ...]), ...]``: every instantiation by its own ``nvcc``, all in parallel,
    then each library's link; each ``_build/<stem>.so`` with its ptxas report
    beside it. Raises ``RuntimeError`` naming each instantiation or library
    that fails, with the compiler's message."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        nvcc, jobs = _nvcc(), []
        for stem, n, keys in libs:
            for tags, dtype, nz in keys:
                name = _entry_name(n, tags, dtype, nz)
                obj = pathlib.Path(tmp) / f"{name}.o"
                jobs.append((stem, name, obj, _compile(nvcc, n, tags, dtype, nz, obj)))
        results = _run_all([cmd for *_, cmd in jobs])
        failed = [f"{name}: nvcc exit {rc}\n{err}"
                  for (_, name, _, _), (rc, err, _) in zip(jobs, results) if rc != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        links = [[nvcc, *_ARCH, "-shared", "-o", str(pathlib.Path(tmp) / f"{stem}.so"),
                  *(str(obj) for s, _, obj, _ in jobs if s == stem)]
                 for stem, _, _ in libs]
        failed = [f"{stem}.so: link exit {rc}\n{err}"
                  for (stem, _, _), (rc, err, _) in zip(libs, _run_all(links, slotted=False))
                  if rc != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        for stem, _, _ in libs:
            report = "".join(f"== {name}\ncpu_s {cpu:.1f}\n{err}"
                             for (s, name, _, _), (_, err, cpu) in zip(jobs, results)
                             if s == stem)
            (_BUILD_DIR / f"{stem}.ptxas.txt").write_text(report)
            os.replace(pathlib.Path(tmp) / f"{stem}.so", _BUILD_DIR / f"{stem}.so")


def build(*names: str) -> list:
    """The loaded libraries of ``csrc/<name>.cu``'s prebuilt instantiations
    for each of ``names``, compiling (in parallel) those not built yet. A
    source that another thread is building is waited for."""
    with _lock:
        locks = [_source_locks.setdefault(n, threading.Lock()) for n in sorted(set(names))]
    for lock in locks:  # in sorted order, so that two builds cannot deadlock
        lock.acquire()
    try:
        todo = [n for n in names if n not in _libs]
        stems = {n: _stem(n) for n in todo}
        missing = [n for n in todo if not (_BUILD_DIR / f"{stems[n]}.so").exists()]
        if missing:
            _make([(stems[n], n, INSTANTIATIONS[n]) for n in missing])
        for n in todo:
            _libs[n] = ctypes.CDLL(str(_BUILD_DIR / f"{stems[n]}.so"))
        return [_libs[n] for n in names]
    finally:
        for lock in locks:
            lock.release()


def _entry_name(name: str, tags, dtype: torch.dtype, nz: int) -> str:
    return "_".join((name, *tags, _SUFFIX[dtype][0], f"nz{nz}"))


def _compile(nvcc: str, name: str, tags, dtype: torch.dtype, nz: int, obj) -> list:
    """The ``nvcc`` command that compiles one instantiation of
    ``csrc/<name>.cu`` into the object ``obj``."""
    return [nvcc, *_ARCH, "-std=c++17", "-O3", *FLAGS.get(name, {}).get(dtype, ()),
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-DSOIL_ENTRY={_entry_name(name, tags, dtype, nz)}",
            f"-DSOIL_T={_SUFFIX[dtype][1]}", f"-DSOIL_NZ={nz}",
            *(f"-D{d}" for t in tags for d in _DEFINES[t]), "-c", "-o", str(obj),
            str(_CSRC / f"{name}.cu")]


def _build_one(name: str, tags: tuple, dtype: torch.dtype, nz: int):
    """The loaded library of one instantiation of ``csrc/<name>.cu`` that
    ``INSTANTIATIONS`` does not list, ``_build/<stem>-<entry point>.so``,
    compiled and linked alone the first time it is asked for; a second
    thread that asks for it meanwhile waits for that build."""
    ename = _entry_name(name, tags, dtype, nz)
    key = (name, ename)
    with _lock:
        lock = _source_locks.setdefault(key, threading.Lock())
    with lock:
        if key in _libs:
            return _libs[key]
        stem = f"{_stem(name)}-{ename}"
        if not (_BUILD_DIR / f"{stem}.so").exists():
            _make([(stem, name, [(tags, dtype, nz)])])
        _libs[key] = ctypes.CDLL(str(_BUILD_DIR / f"{stem}.so"))
        return _libs[key]


def entry(name: str, dtype: torch.dtype, nz: int, argtypes, tags=(), suffix: str = ""):
    """The entry point ``<name>[_<tag>...]_<f32|f64>_nz<NZ><suffix>`` of
    ``csrc/<name>.cu``, typed with ``argtypes`` and an int result (the
    launch's CUDA error code; ``suffix`` names another function of the
    instantiation): from the source's library of prebuilt
    instantiations (``INSTANTIATIONS``, built together at first use), or,
    for any other, from its own library, built at its first use. Raises
    ``ValueError`` for a dtype other than float32 or float64 and
    ``RuntimeError`` with ``nvcc``'s message where a build fails."""
    tags = tuple(tags)
    if dtype not in _SUFFIX:
        raise ValueError(f"{name} is built for float32 and float64, not {dtype}")
    if (tags, dtype, nz) in INSTANTIATIONS[name]:
        lib = build(name)[0]
    else:
        lib = _build_one(name, tags, dtype, nz)
    fn = getattr(lib, _entry_name(name, tags, dtype, nz) + suffix)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def ptxas_report(name: str) -> str:
    """ptxas's ``-v`` output of the current build of ``csrc/<name>.cu``: the
    prebuilt library's, then that of each instantiation built alone so far
    ('' before any build)."""
    stem = _stem(name)
    paths = [_BUILD_DIR / f"{stem}.ptxas.txt",
             *sorted(_BUILD_DIR.glob(f"{stem}-*.ptxas.txt"))]
    return "".join(p.read_text() for p in paths if p.exists())
