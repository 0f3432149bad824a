"""The port's kernel build (``ops/cuda_build.py``) with ``nvcc`` mocked, on a
host without a card: an instantiation that ``INSTANTIATIONS`` does not list
is compiled alone at its first launch into its own library, with the same
defines and flags as a listed one; a listed one comes from its source's
prebuilt library; a failing ``nvcc`` or link raises ``RuntimeError`` with
the key and the compiler's message, and nothing falls back.

``_nvcc`` and ``_run_all`` are replaced: the fake ``_run_all`` records each
command and writes the file it names after ``-o``, and ``ctypes.CDLL`` is
replaced by a stand-in that records the path it loads.
"""
import ctypes
import sys
import threading
import time

import pytest
import torch

import terrarium_tpu_torch as tp
from terrarium_tpu_torch.ops import cuda_build as cb
from terrarium_tpu_torch.ops import fused_step as fs
from terrarium_tpu_torch.ops import fused_vjp as fv
from terrarium_tpu_torch.ops import land_step as ls
from terrarium_tpu_torch.timesteppers import integrator

F32, F64 = torch.float32, torch.float64


class _Lib:
    """Stands in for a loaded library: every attribute is an entry point."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        fn.name = name
        return fn


class _Nvcc:
    """The fake ``_run_all``: records the commands of each call; ``fail``
    makes the compiles (``"compile"``) or the links (``"link"``) exit 1."""

    def __init__(self, fail=None, delay=0.0):
        self.calls, self.fail, self.delay = [], fail, delay

    def __call__(self, cmds, slotted=True):
        assert slotted == all("-c" in c for c in cmds)  # the links run at once
        self.calls.append(cmds)
        time.sleep(self.delay)
        out = []
        for cmd in cmds:
            kind = "link" if "-shared" in cmd else "compile"
            if kind == self.fail:
                out.append((1, f"fake {kind} error: {cmd[-1]}", 0.1))
                continue
            path = cmd[cmd.index("-o") + 1]
            with open(path, "w") as f:
                f.write(kind)
            out.append((0, "ptxas info    : Used 96 registers, 0 bytes spill stores", 2.5))
        return out

    def compiles(self):
        return [c for cmds in self.calls for c in cmds if "-c" in c]

    def links(self):
        return [c for cmds in self.calls for c in cmds if "-shared" in c]


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = _Nvcc()
    monkeypatch.setattr(cb, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cb, "_libs", {})
    monkeypatch.setattr(cb, "_source_locks", {})
    monkeypatch.setattr(cb, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cb, "_run_all", nvcc)
    monkeypatch.setattr(ctypes, "CDLL", _Lib)
    return nvcc


def _defines(cmd):
    return {a for a in cmd if a.startswith("-D")}


def _heat_column_tags():
    """The tags that ``run`` gives `examples/soil_heat_column.py`'s
    composition (the heat-only SoilModel by ForwardEuler, BASELINE #1)."""
    grid = tp.ColumnGrid.of(cells=1, spacing=tp.ExponentialSpacing(N=10),
                            dtype=torch.float32, device="cpu")
    model = tp.SoilModel(grid=grid, initializer=tp.SoilInitializer(
        energy=tp.QuasiThermalSteadyState(T0=-1.0), hydrology=tp.ConstantSaturation(sat=1.0)))
    sim = tp.initialize(model, tp.ForwardEuler(),
                        boundary_conditions=tp.PrescribedSurfaceTemperature(1.0))
    stepper, physics = integrator.column_scheme(sim.model, sim.timestepper, sim.ctx)
    return fs.kernel_tags(stepper, physics, 1, plain_euler=())


def test_unlisted_key_is_built_alone_at_first_use(fake_nvcc):
    """euler/heat f32 Nz 10, which ``INSTANTIATIONS`` does not list: one
    compile with that key's defines and the flags of a listed one, one
    link into ``<stem>-<entry point>.so``, ptxas's report beside it (and in
    ``ptxas_report``); a second call builds nothing."""
    tags = _heat_column_tags()
    assert tags == ("euler", "heat")
    assert (tags, F32, 10) not in cb.INSTANTIATIONS["soil_column_rollout"]
    fn = cb.entry("soil_column_rollout", F32, 10, [ctypes.c_int], tags=tags)
    name = "soil_column_rollout_euler_heat_f32_nz10"
    assert fn.name == name and fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    (compile_,), (link,) = fake_nvcc.compiles(), fake_nvcc.links()
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=float", "-DSOIL_NZ=10",
                                  "-DSOIL_STEPPER=0", "-DSOIL_HEAT=1"}
    listed = cb._compile("nvcc", "soil_column_rollout", ("euler", "heat"), F32, 30, "x.o")
    assert [a for a in compile_ if not a.startswith("-D") and not a.endswith(".o")] == \
        [a for a in listed if not a.startswith("-D") and not a.endswith(".o")]
    so = cb._BUILD_DIR / f"{cb._stem('soil_column_rollout')}-{name}.so"
    assert so.exists() and cb._libs[("soil_column_rollout", name)].path == str(so)
    assert link[link.index("-o") + 1].endswith(so.name)
    report = cb.ptxas_report("soil_column_rollout")
    assert report.startswith(f"== {name}\ncpu_s 2.5\n") and "Used 96 registers" in report
    n = len(fake_nvcc.calls)
    fn2 = cb.entry("soil_column_rollout", F32, 10, [ctypes.c_int], tags=tags)
    assert len(fake_nvcc.calls) == n and fn2.name == name


def test_land_float64_key_keeps_the_source_flags(fake_nvcc):
    """A bare-ground Van Genuchten/Mualem land column at float64 Nz 12,
    built alone, takes the land source's float64 flag (no contracted
    multiply-adds) and its composition's defines; its float32 build does
    not take the flag."""
    grid = tp.ColumnGrid.of(cells=2, spacing=tp.ExponentialSpacing(N=12), dtype=F64,
                            device="cpu")
    soil = tp.SoilEnergyWaterCarbon(hydrology=tp.SoilHydrology(
        vertical_flow=tp.RichardsEq(), hydraulic_properties=tp.ConstantSoilHydraulics(
            swrc=tp.VanGenuchten(alpha=2.0, n=2.0),
            unsat_hydraulic_cond=tp.UnsatKVanGenuchten())))
    tags = ls.land_composition(tp.LandModel(grid=grid, soil=soil))
    assert tags == ("bare", "richards", "vg", "mualem")
    for dtype in (F64, F32):
        cb.entry("land_column_rollout", dtype, 12, [], tags=tags)
    f64, f32 = fake_nvcc.compiles()
    assert "-fmad=false" in f64 and "-fmad=false" not in f32
    assert {"-DLAND_VEG=0", "-DLAND_RICHARDS=1", "-DSOIL_HEAT=0", "-DLAND_CURVE=0",
            "-DLAND_COND=0", "-DSOIL_T=double", "-DSOIL_NZ=12"} <= _defines(f64)
    assert len(fake_nvcc.links()) == 2


def test_listed_key_takes_the_prebuilt_library(fake_nvcc):
    """A listed key builds its source's whole prebuilt set, one compile an
    instantiation and one link into ``<stem>.so``, and is read from it; a
    key built alone afterwards comes from its own library."""
    listed = ("implicit", "picard", "veg", "richards", "bc", "linear")
    assert (listed, F32, 20) in cb.INSTANTIATIONS["land_column_rollout"]
    fn = cb.entry("land_column_rollout", F32, 20, [], tags=listed)
    stem = cb._stem("land_column_rollout")
    assert cb._libs["land_column_rollout"].path == str(cb._BUILD_DIR / f"{stem}.so")
    assert fn.name == "land_column_rollout_implicit_picard_veg_richards_bc_linear_f32_nz20"
    assert len(fake_nvcc.compiles()) == len(cb.INSTANTIATIONS["land_column_rollout"])
    assert len(fake_nvcc.links()) == 1
    other = ("implicit", "picard", "veg", "richards", "bc", "linear", "snow")
    cb.entry("land_column_rollout", F32, 20, [], tags=other)
    assert len(fake_nvcc.links()) == 2
    assert len(cb.ptxas_report("land_column_rollout").split("== ")) == \
        len(cb.INSTANTIATIONS["land_column_rollout"]) + 2


@pytest.mark.parametrize("fail", ["compile", "link"])
def test_a_failing_build_raises(fake_nvcc, fail):
    """A failing ``nvcc`` or link raises ``RuntimeError`` naming the key's
    entry point and carrying the compiler's message; nothing is loaded, and
    the next launch tries the build again."""
    fake_nvcc.fail = fail
    with pytest.raises(RuntimeError, match=rf"soil_column_rollout_euler_heat_f32_nz10(\.so)?: "
                                           rf"{fail if fail == 'link' else 'nvcc'} exit 1"
                                           rf"\n.*fake {fail} error"):
        cb.entry("soil_column_rollout", F32, 10, [], tags=("euler", "heat"))
    assert not cb._libs
    n = len(fake_nvcc.calls)
    fake_nvcc.fail = None
    cb.entry("soil_column_rollout", F32, 10, [], tags=("euler", "heat"))
    assert len(fake_nvcc.calls) == n + 2


def test_other_dtypes_raise(fake_nvcc):
    with pytest.raises(ValueError, match="float32 and float64"):
        cb.entry("soil_column_rollout", torch.float16, 10, [], tags=("euler", "heat"))
    assert not fake_nvcc.calls


def test_threads_build_a_key_once(fake_nvcc):
    """More threads than cores launch two unlisted keys at once, with a
    short switch interval: each key is built once, the other threads wait
    for its build."""
    fake_nvcc.delay = 0.05
    got = []
    keys = [("heun", "heat"), ("euler", "heat")]

    def launch(i):
        got.append(cb.entry("soil_column_rollout", F64, 12, [], tags=keys[i % 2]).name)

    threads = [threading.Thread(target=launch, args=(i,)) for i in range(32)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(set(got)) == ["soil_column_rollout_euler_heat_f64_nz12",
                                "soil_column_rollout_heun_heat_f64_nz12"] and len(got) == 32
    assert len(fake_nvcc.compiles()) == 2 and len(fake_nvcc.links()) == 2


def test_run_all_runs_real_processes():
    """``_run_all`` (not mocked): each command's exit code and standard
    error, in the commands' order, in slots or, for the links, at once."""
    cmds = [["sh", "-c", f"echo e{i} >&2; exit {i}"] for i in range(3)]
    for slotted in (True, False):
        out = cb._run_all(cmds, slotted=slotted)
        assert [(rc, err) for rc, err, _ in out] == [(i, f"e{i}\n") for i in range(3)]
        assert all(cpu >= 0.0 for *_, cpu in out)


@pytest.mark.parametrize("stepper", ["euler", "heun", "implicit_pcr", "implicit_thomas",
                                     "implicit_picard"])
def test_group_rollout_keys(fake_nvcc, stepper):
    """ForwardEuler, Heun and ImplicitEuler (each solver; more than one
    Picard iteration: the entry of both solvers) over heat + Richards launch
    the group rollout source (``csrc/soil_column_group_rollout.cu``) and no
    longer the one-thread source's prebuilt set: an unlisted depth (40) is
    built alone with its stepper's defines and no group size (the source
    takes ``soil::group_lanes``, ImplicitEuler
    ``soil::implicit_group_lanes``); a ``g<G>`` tag, for measuring one group
    size against another, adds ``SOIL_GROUP``; ``suffix`` reads the
    instantiation's other function (its resident warps)."""
    stepper, _, solver = stepper.partition("_")
    iters = 2 if solver == "picard" else 1
    tags = fs.kernel_tags(stepper, "richards", iters, plain_euler=(),
                          solver="pcr" if solver == "picard" else (solver or "pcr"))
    assert (stepper, "richards") in fs.GROUP_SCHEMES
    assert tags == ((stepper, "richards") if stepper != "implicit"
                    else (stepper, solver, "richards"))
    assert all(t != tags for t, _, _ in cb.INSTANTIATIONS["soil_column_rollout"])
    assert (tags, F32, 30) in cb.INSTANTIATIONS["soil_column_group_rollout"]
    assert (tags, F32, 40) not in cb.INSTANTIATIONS["soil_column_group_rollout"]
    fn = cb.entry("soil_column_group_rollout", F32, 40, fs._GROUP_ARGTYPES, tags=tags)
    name = f"soil_column_group_rollout_{'_'.join(tags)}_f32_nz40"
    assert fn.name == name and fn.argtypes == fs._GROUP_ARGTYPES
    (compile_,) = fake_nvcc.compiles()
    defines = {"euler": {"-DSOIL_STEPPER=0"}, "heun": {"-DSOIL_STEPPER=1"},
               "implicit": {"-DSOIL_STEPPER=2"}}[stepper]
    defines |= {"pcr": {"-DSOIL_SOLVER=1"}, "thomas": {"-DSOIL_SOLVER=0"},
                "picard": {"-DSOIL_SOLVER=2", "-DSOIL_PICARD=1"}, "": set()}[solver]
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=float", "-DSOIL_NZ=40",
                                  "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1", *defines}
    warps = cb.entry("soil_column_group_rollout", F32, 40, [], tags=tags, suffix="_warps")
    assert warps.name == f"{name}_warps" and len(fake_nvcc.compiles()) == 1
    cb.entry("soil_column_group_rollout", F32, 20, [], tags=(*tags, "g8"))
    assert "-DSOIL_GROUP=8" in fake_nvcc.compiles()[-1]
    # the group entry takes the one-thread entry's arguments (the solver and
    # the Picard count) and the hand-off counter before the stream
    assert fs._GROUP_ARGTYPES[:-2] == fs._ARGTYPES[:-1]


@pytest.mark.parametrize("solver", ["pcr", "thomas", "picard"])
def test_group_segment_vjp_keys(fake_nvcc, solver):
    """The segment VJP of ImplicitEuler over heat + Richards (each solver;
    more than one Picard iteration: the entry of both solvers) is prebuilt
    from the group source (``csrc/soil_column_group_segment_vjp.cu``) at the
    gradient's float32 Nz 30 and the float64 checks' Nz 16 and no longer in
    the one-thread source's prebuilt set, which still builds the same tags
    alone on demand (to time one layout against the other); an unlisted
    depth is built alone with the scheme's defines and no group size (the
    source takes ``soil::implicit_group_lanes``); ``g<G>`` and ``mb<B>``
    tags, for measuring, add ``SOIL_GROUP`` and ``SOIL_MIN_BLOCKS``; the
    ``_warps`` suffix reads the instantiation's resident warps and G."""
    iters = 2 if solver == "picard" else 1
    tags = fv.vjp_tags("implicit", "richards", "pcr" if solver == "picard" else solver, iters)
    assert tags == ("implicit", solver, "richards")
    assert ("implicit", "richards") in fv.GROUP_SCHEMES
    for dtype, nz in ((F32, 30), (F64, 16)):
        assert (tags, dtype, nz) in cb.INSTANTIATIONS["soil_column_group_segment_vjp"]
    assert all(t != tags for t, _, _ in cb.INSTANTIATIONS["soil_column_segment_vjp"])
    fn = cb.entry("soil_column_group_segment_vjp", F32, 40, fv._ARGTYPES, tags=tags)
    name = f"soil_column_group_segment_vjp_{'_'.join(tags)}_f32_nz40"
    assert fn.name == name and fn.argtypes == fv._ARGTYPES
    (compile_,) = fake_nvcc.compiles()
    assert compile_[-1].endswith("soil_column_group_segment_vjp.cu")
    defines = {"pcr": {"-DSOIL_SOLVER=1"}, "thomas": {"-DSOIL_SOLVER=0"},
               "picard": {"-DSOIL_SOLVER=2", "-DSOIL_PICARD=1"}}[solver]
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=float", "-DSOIL_NZ=40",
                                  "-DSOIL_STEPPER=2", "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1",
                                  *defines}
    warps = cb.entry("soil_column_group_segment_vjp", F32, 40, [], tags=tags, suffix="_warps")
    assert warps.name == f"{name}_warps" and len(fake_nvcc.compiles()) == 1
    one = cb.entry("soil_column_segment_vjp", F32, 30, fv._ARGTYPES, tags=tags)
    assert one.name == f"soil_column_segment_vjp_{'_'.join(tags)}_f32_nz30"
    assert fake_nvcc.compiles()[-1][-1].endswith("soil_column_segment_vjp.cu")
    cb.entry("soil_column_group_segment_vjp", F32, 30, [], tags=(*tags, "g8", "mb1"))
    assert {"-DSOIL_GROUP=8", "-DSOIL_MIN_BLOCKS=1"} <= _defines(fake_nvcc.compiles()[-1])


def _land_params(composition):
    """``LandParams`` of `test_torch_land_adjoint_host.py`'s composition."""
    from test_torch_land_adjoint_host import composition_model

    grid = tp.ColumnGrid.of(cells=2, spacing=tp.ExponentialSpacing(N=20), dtype=F32,
                            device="cpu")
    return ls.LandParams.of(composition_model(grid, composition), F32)


@pytest.mark.parametrize("solver", ["pcr", "thomas", "picard"])
def test_land_group_segment_vjp_keys(fake_nvcc, solver):
    """The land segment VJP of ImplicitEuler over the vegetated bench
    composition (each solver; more than one Picard iteration: the entry of
    both solvers) is prebuilt from the group source
    (``csrc/land_column_group_segment_vjp.cu``) at float32 and float64 Nz 20
    and no longer in the one-thread source's prebuilt set, which still
    builds the same tags alone on demand (to time one layout against the
    other); an unlisted depth is built alone with the scheme's and the
    composition's defines and no group size (the source takes
    ``land::implicit_group_lanes``), its float64 build with the land
    sources' ``-fmad=false``; ``g<G>`` and ``mb<B>`` tags add ``SOIL_GROUP``
    and ``SOIL_MIN_BLOCKS``; the ``_warps`` suffix reads the instantiation's
    resident warps and G."""
    from terrarium_tpu_torch.ops import land_vjp as lv

    params = _land_params("coupled")
    iters = 2 if solver == "picard" else 1
    tags = lv.check_scheme(params, "implicit", "pcr" if solver == "picard" else solver,
                           iters) + params.tags
    assert tags == ("implicit", solver, "veg", "richards", "bc", "linear")
    for dtype in (F32, F64):
        assert (tags, dtype, 20) in cb.INSTANTIATIONS["land_column_group_segment_vjp"]
    assert all(t != tags for t, _, _ in cb.INSTANTIATIONS["land_column_segment_vjp"])
    assert cb.FLAGS["land_column_group_segment_vjp"] == {F64: ("-fmad=false",)}
    argtypes = lv._argtypes(F64)
    fn = cb.entry("land_column_group_segment_vjp", F64, 15, argtypes, tags=tags)
    name = f"land_column_group_segment_vjp_{'_'.join(tags)}_f64_nz15"
    assert fn.name == name and fn.argtypes == argtypes
    (compile_,) = fake_nvcc.compiles()
    assert compile_[-1].endswith("land_column_group_segment_vjp.cu")
    assert "-fmad=false" in compile_
    defines = {"pcr": {"-DSOIL_SOLVER=1"}, "thomas": {"-DSOIL_SOLVER=0"},
               "picard": {"-DSOIL_SOLVER=2", "-DSOIL_PICARD=1"}}[solver]
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=double", "-DSOIL_NZ=15",
                                  "-DSOIL_STEPPER=2", "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1",
                                  "-DLAND_VEG=1", "-DLAND_CURVE=1", "-DLAND_COND=1", *defines}
    warps = cb.entry("land_column_group_segment_vjp", F64, 15, [], tags=tags, suffix="_warps")
    assert warps.name == f"{name}_warps" and len(fake_nvcc.compiles()) == 1
    cb.entry("land_column_group_segment_vjp", F32, 15, argtypes, tags=tags)
    assert "-fmad=false" not in fake_nvcc.compiles()[-1]
    one = cb.entry("land_column_segment_vjp", F32, 20, argtypes, tags=tags)
    assert one.name == f"land_column_segment_vjp_{'_'.join(tags)}_f32_nz20"
    assert fake_nvcc.compiles()[-1][-1].endswith("land_column_segment_vjp.cu")
    cb.entry("land_column_group_segment_vjp", F32, 20, [], tags=(*tags, "g8", "mb1"))
    assert {"-DSOIL_GROUP=8", "-DSOIL_MIN_BLOCKS=1"} <= _defines(fake_nvcc.compiles()[-1])


def test_land_group_segment_vjp_has_a_kernel_per_solver():
    """The group source's kernel takes the solver as a template argument and
    its entry launches the kernel of the solver its argument names, so that
    the Picard entry (``SOIL_SOLVER=2``) holds a kernel of each solver and
    every other entry one; the group size is
    ``land::implicit_group_lanes(NZ, SOLVER)`` of that solver."""
    src = (cb._CSRC / "land_column_group_segment_vjp.cu").read_text()
    assert "template <typename T, int NZ, int G, int SOLVER>\n__global__" in src
    assert "land::implicit_group_lanes(NZ, SOLVER)" in src
    assert "if (solver == soil::SOLVER_THOMAS) return SOIL_LAUNCH(soil::SOLVER_THOMAS);" in src
    assert "return SOIL_LAUNCH(ENTRY_SOLVER);" in src


@pytest.mark.parametrize("composition,stepper,source", [
    ("coupled", "implicit", "land_column_group_segment_vjp"),
    ("consistent", "implicit", "land_column_group_segment_vjp"),
    ("bare_vg_mualem", "implicit", "land_column_group_segment_vjp"),
    ("vg_mualem", "implicit", "land_column_group_segment_vjp"),
    ("bare_richards", "implicit", "land_column_group_segment_vjp"),
    ("consistent_snow", "implicit", "land_column_segment_vjp"),
    ("bare_bc_mo_snow", "implicit", "land_column_segment_vjp"),
    ("veg_noflow", "implicit", "land_column_segment_vjp"),
    ("bare", "implicit", "land_column_segment_vjp"),
    ("coupled", "euler", "land_column_segment_vjp"),
    ("coupled", "heun", "land_column_segment_vjp"),
])
def test_land_segment_vjp_routes_by_type(composition, stepper, source):
    """``land_column_segment_vjp`` takes its source from the composition's
    type (``land_vjp.vjp_source``, with no switch): ImplicitEuler over
    Richards flow without a snowpack, with or without vegetation and with
    either curve and conductivity, the group kernel; a snowpack, ``NoFlow``,
    ForwardEuler and Heun the one-thread kernel."""
    from terrarium_tpu_torch.ops import land_vjp as lv

    params = _land_params(composition)
    assert lv.vjp_source(params, stepper) == source
    assert ("snow" in params.tags or params.tags[1] == "noflow" or stepper != "implicit") == (
        source == "land_column_segment_vjp")
