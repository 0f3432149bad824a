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
    multiply-adds) and its composition's defines; its float32 build takes
    the source's float32 flag, the same one once (the one-thread land
    rollout contracts none at either dtype: ROADMAP C3)."""
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
    assert f64.count("-fmad=false") == 1 and f32.count("-fmad=false") == 1
    assert "-DSOIL_T=float" in _defines(f32)
    assert {"-DLAND_VEG=0", "-DLAND_RICHARDS=1", "-DSOIL_HEAT=0", "-DLAND_CURVE=0",
            "-DLAND_COND=0", "-DSOIL_T=double", "-DSOIL_NZ=12"} <= _defines(f64)
    assert len(fake_nvcc.links()) == 2


def test_listed_key_takes_the_prebuilt_library(fake_nvcc):
    """A listed key builds its source's whole prebuilt set, one compile an
    instantiation and one link into ``<stem>.so``, and is read from it; a
    key built alone afterwards comes from its own library."""
    listed = ("veg", "richards", "bc", "linear")
    assert (listed, F32, 20) in cb.INSTANTIATIONS["land_column_rollout"]
    fn = cb.entry("land_column_rollout", F32, 20, [], tags=listed)
    stem = cb._stem("land_column_rollout")
    assert cb._libs["land_column_rollout"].path == str(cb._BUILD_DIR / f"{stem}.so")
    assert fn.name == "land_column_rollout_veg_richards_bc_linear_f32_nz20"
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


#: the prebuilt sizes of the group segment VJP of ForwardEuler (the gradient
#: grids) and of Heun (its forward kernel's)
EXPLICIT_VJP_SIZES = {"euler": ((F32, 20), (F64, 20), (F32, 30), (F64, 30)),
                      "heun": ((F32, 30), (F64, 15))}


@pytest.mark.parametrize("stepper", list(EXPLICIT_VJP_SIZES))
def test_explicit_group_segment_vjp_keys(fake_nvcc, stepper):
    """The segment VJP of ForwardEuler and Heun over heat + Richards (rows 3
    and 3'a) is prebuilt from the group source
    (``csrc/soil_column_group_segment_vjp.cu``), its tags naming the stepper
    (ForwardEuler's too), and no longer in the one-thread source's prebuilt
    set, which still builds the same scheme alone on demand (to time one
    layout against the other); an unlisted depth is built alone with the
    stepper's defines and no group size (the source takes
    ``soil::vjp_group_lanes``); ``g<G>`` and ``mb<B>`` tags add
    ``SOIL_GROUP`` and ``SOIL_MIN_BLOCKS``; the ``_warps`` suffix reads the
    instantiation's resident warps and G."""
    group_src = "soil_column_group_segment_vjp"
    tags = fv.vjp_tags(stepper, "richards", "pcr", 1)
    assert tags == (stepper, "richards")
    for dtype, nz in EXPLICIT_VJP_SIZES[stepper]:
        assert (tags, dtype, nz) in cb.INSTANTIATIONS[group_src]
    one_thread = fs.kernel_tags(stepper, "richards", 1)
    assert one_thread == ((stepper, "richards") if stepper == "heun" else ())
    assert all(t not in (one_thread, tags) for t, _, _ in cb.INSTANTIATIONS[
        "soil_column_segment_vjp"])
    fn = cb.entry(group_src, F32, 40, fv._ARGTYPES, tags=tags)
    name = f"{group_src}_{stepper}_richards_f32_nz40"
    assert fn.name == name and fn.argtypes == fv._ARGTYPES
    (compile_,) = fake_nvcc.compiles()
    assert compile_[-1].endswith(f"{group_src}.cu")
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=float", "-DSOIL_NZ=40",
                                  f"-DSOIL_STEPPER={0 if stepper == 'euler' else 1}",
                                  "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1"}
    warps = cb.entry(group_src, F32, 40, [], tags=tags, suffix="_warps")
    assert warps.name == f"{name}_warps" and len(fake_nvcc.compiles()) == 1
    one = cb.entry("soil_column_segment_vjp", F32, 20, fv._ARGTYPES, tags=one_thread)
    assert one.name == "_".join(("soil_column_segment_vjp", *one_thread, "f32_nz20"))
    assert fake_nvcc.compiles()[-1][-1].endswith("soil_column_segment_vjp.cu")
    cb.entry(group_src, F32, 30, [], tags=(*tags, "g16", "mb3"))
    assert {"-DSOIL_GROUP=16", "-DSOIL_MIN_BLOCKS=3"} <= _defines(fake_nvcc.compiles()[-1])


@pytest.mark.parametrize("stepper,physics,source", [
    ("euler", "richards", "soil_column_group_segment_vjp"),
    ("heun", "richards", "soil_column_group_segment_vjp"),
    ("implicit", "richards", "soil_column_group_segment_vjp"),
    ("euler", "heat", "soil_column_segment_vjp"),
    ("heun", "heat", "soil_column_segment_vjp"),
    ("implicit", "heat", "soil_column_segment_vjp"),
])
def test_segment_vjp_routes_by_type(stepper, physics, source):
    """``GROUP_SCHEMES`` sends every stepper over heat + Richards to the
    group source and the three heat-only schemes to the one-thread source;
    each scheme has a segment VJP."""
    assert (stepper, physics) in fv.VJP_SCHEMES
    assert fv.vjp_source(stepper, physics) == source
    assert ((stepper, physics) in fv.GROUP_SCHEMES) == (source == fv._GROUP_NAME)


@pytest.mark.parametrize("stepper", ["euler", "heun"])
def test_explicit_segment_vjp_refuses_picard_iterations(stepper):
    """Picard iterations are ImplicitEuler's: the wrapper and the build tags
    refuse a count other than 1 for ForwardEuler and Heun, on any device,
    and the group source's entries return cudaErrorInvalidValue for one
    (no ``SOIL_PICARD``), as a ``static_assert`` keeps an explicit entry
    from being built with it."""
    with pytest.raises(ValueError, match="Picard"):
        fv.vjp_tags(stepper, "richards", "pcr", 2)
    with pytest.raises(ValueError, match="Picard"):
        fv.soil_column_segment_vjp(*([None] * 13), stepper=stepper, picard_iters=2)
    with pytest.raises(ValueError, match="Picard"):
        fv.soil_column_segment_vjp_plain(*([None] * 13), stepper=stepper, picard_iters=3)
    src = (cb._CSRC / "soil_column_group_segment_vjp.cu").read_text()
    assert "(!SOIL_PICARD && picard != 1)" in src
    assert "SOIL_STEPPER == soil::STEPPER_IMPLICIT || !SOIL_PICARD" in src
    assert "template <typename T, int NZ, int G, int STEPPER, int SOLVER>\n__global__" in src
    assert "soil::vjp_group_lanes(NZ, STEPPER, SOLVER)" in src


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
    """The group source's kernel takes the stepper and the solver as
    template arguments and its entry launches the kernel of the solver its
    argument names, so that the Picard entry (``SOIL_SOLVER=2``) holds a
    kernel of each solver and every other entry one; the group size is
    ``land::implicit_group_lanes(NZ, SOLVER)`` of that solver, Heun's
    ``land::heun_group_lanes(NZ)``."""
    src = (cb._CSRC / "land_column_group_segment_vjp.cu").read_text()
    assert "template <typename T, int NZ, int G, int STEPPER, int SOLVER>\n__global__" in src
    assert "land::implicit_group_lanes(NZ, SOLVER)" in src
    assert "land::heun_group_lanes(NZ)" in src
    assert "if (solver == soil::SOLVER_THOMAS) return SOIL_LAUNCH(soil::SOLVER_THOMAS);" in src
    assert "return SOIL_LAUNCH(ENTRY_SOLVER);" in src


@pytest.mark.parametrize("composition,stepper,source", [
    ("coupled", "implicit", "land_column_group_segment_vjp"),
    ("consistent", "implicit", "land_column_group_segment_vjp"),
    ("bare_vg_mualem", "implicit", "land_column_group_segment_vjp"),
    ("vg_mualem", "implicit", "land_column_group_segment_vjp"),
    ("bare_richards", "implicit", "land_column_group_segment_vjp"),
    ("consistent_snow", "implicit", "land_column_group_segment_vjp"),
    ("bare_bc_mo_snow", "implicit", "land_column_group_segment_vjp"),
    ("veg_noflow", "implicit", "land_column_segment_vjp"),
    ("bare", "implicit", "land_column_segment_vjp"),
    ("coupled", "euler", "land_column_segment_vjp"),
    ("coupled", "heun", "land_column_group_segment_vjp"),
    ("bare_vg_mualem", "heun", "land_column_group_segment_vjp"),
    ("consistent_snow", "heun", "land_column_group_segment_vjp"),
    ("veg_noflow", "heun", "land_column_segment_vjp"),
    ("consistent_snow", "euler", "land_column_segment_vjp"),
])
def test_land_segment_vjp_routes_by_type(composition, stepper, source):
    """``land_column_segment_vjp`` takes its source from the composition's
    type (``land_vjp.vjp_source``, with no switch): ImplicitEuler and Heun
    over Richards flow, with or without a snowpack, with or without
    vegetation and with either curve and conductivity, the group kernel;
    ``NoFlow`` and ForwardEuler (a snowpack too) the one-thread kernel."""
    from terrarium_tpu_torch.ops import land_vjp as lv

    params = _land_params(composition)
    assert lv.vjp_source(params, stepper) == source
    assert (params.tags[1] == "noflow" or stepper == "euler") == (
        source == "land_column_segment_vjp")


@pytest.mark.parametrize("solver", ["pcr", "thomas", "picard"])
def test_land_group_rollout_keys(fake_nvcc, solver):
    """The land rollout of ImplicitEuler over the vegetated bench
    composition (each solver; more than one Picard iteration: the entry of
    both solvers) is prebuilt from the group source
    (``csrc/land_column_group_rollout.cu``) at float32 and float64 Nz 20
    and no longer in the one-thread source's prebuilt set, which still
    builds the same tags alone on demand (to time one layout against the
    other); an unlisted depth is built alone with the scheme's and the
    composition's defines and no group size (the source takes
    ``land::implicit_group_lanes``), its float64 build with the land
    sources' ``-fmad=false``; ``g<G>`` (G 2 to 32) and ``mb<B>`` tags add
    ``SOIL_GROUP`` and ``SOIL_MIN_BLOCKS``; the ``_warps`` suffix reads the
    instantiation's resident warps and G."""
    params = _land_params("coupled")
    tags = ls.implicit_tags("pcr" if solver == "picard" else solver,
                            2 if solver == "picard" else 1) + params.tags
    assert tags == ("implicit", solver, "veg", "richards", "bc", "linear")
    for dtype in (F32, F64):
        assert (tags, dtype, 20) in cb.INSTANTIATIONS["land_column_group_rollout"]
    assert all(t != tags for t, _, _ in cb.INSTANTIATIONS["land_column_rollout"])
    assert cb.FLAGS["land_column_group_rollout"] == {F64: ("-fmad=false",)}
    argtypes = ls._argtypes(F64)
    fn = cb.entry("land_column_group_rollout", F64, 15, argtypes, tags=tags)
    name = f"land_column_group_rollout_{'_'.join(tags)}_f64_nz15"
    assert fn.name == name and fn.argtypes == argtypes
    (compile_,) = fake_nvcc.compiles()
    assert compile_[-1].endswith("land_column_group_rollout.cu")
    assert "-fmad=false" in compile_
    defines = {"pcr": {"-DSOIL_SOLVER=1"}, "thomas": {"-DSOIL_SOLVER=0"},
               "picard": {"-DSOIL_SOLVER=2", "-DSOIL_PICARD=1"}}[solver]
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=double", "-DSOIL_NZ=15",
                                  "-DSOIL_STEPPER=2", "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1",
                                  "-DLAND_VEG=1", "-DLAND_CURVE=1", "-DLAND_COND=1", *defines}
    warps = cb.entry("land_column_group_rollout", F64, 15, [], tags=tags, suffix="_warps")
    assert warps.name == f"{name}_warps" and len(fake_nvcc.compiles()) == 1
    cb.entry("land_column_group_rollout", F32, 15, argtypes, tags=tags)
    assert "-fmad=false" not in fake_nvcc.compiles()[-1]
    one = cb.entry("land_column_rollout", F32, 20, argtypes, tags=tags)
    assert one.name == f"land_column_rollout_{'_'.join(tags)}_f32_nz20"
    assert fake_nvcc.compiles()[-1][-1].endswith("land_column_rollout.cu")
    cb.entry("land_column_group_rollout", F32, 20, [], tags=(*tags, "g2", "mb3"))
    assert {"-DSOIL_GROUP=2", "-DSOIL_MIN_BLOCKS=3"} <= _defines(fake_nvcc.compiles()[-1])


def test_land_group_rollout_has_a_kernel_per_solver():
    """The group rollout's kernel takes the stepper and the solver as
    template arguments and its entry launches the kernel of the solver its
    argument names, so that the Picard entry (``SOIL_SOLVER=2``) holds a
    kernel of each solver and every other entry one; the group size is
    ``land::rollout_group_lanes(NZ, SOLVER)`` of that solver, Heun's
    ``land::heun_rollout_group_lanes(NZ)``, and the step is the group
    column's ``rollout`` over ``picard_step`` or ``heun_step``, the steps
    the segment VJP recomputes with."""
    src = (cb._CSRC / "land_column_group_rollout.cu").read_text()
    assert "template <typename T, int NZ, int G, int STEPPER, int SOLVER>\n__global__" in src
    assert "land::rollout_group_lanes(NZ, SOLVER)" in src
    assert "land::heun_rollout_group_lanes(NZ)" in src
    assert "column.template rollout<STEPPER, SOLVER>(" in src
    assert "if (solver == soil::SOLVER_THOMAS) return SOIL_LAUNCH(soil::SOLVER_THOMAS);" in src
    assert "return SOIL_LAUNCH(ENTRY_SOLVER);" in src
    header = (cb._CSRC / "land_group_step.cuh").read_text()
    assert "picard_step<SOLVER>(U, sat, s, f, dt, inv_dt, iters);" in header
    assert "heun_step(U, sat, s, f, f1, dt);" in header
    assert "rollout_step<STEPPER, SOLVER>(U, sat, s, fr, inputs, col, t, dt, inv_dt, iters);" \
        in header
    assert "heun_stage(U, cs, cx, f0, dt, r, xU, xs, xsurf);" in header


@pytest.mark.parametrize("composition,stepper,source", [
    ("coupled", "implicit", "land_column_group_rollout"),
    ("consistent", "implicit", "land_column_group_rollout"),
    ("bare_vg_mualem", "implicit", "land_column_group_rollout"),
    ("vg_mualem", "implicit", "land_column_group_rollout"),
    ("bare_richards", "implicit", "land_column_group_rollout"),
    ("consistent_snow", "implicit", "land_column_group_rollout"),
    ("bare_bc_mo_snow", "implicit", "land_column_group_rollout"),
    ("veg_noflow", "implicit", "land_column_rollout"),
    ("bare", "implicit", "land_column_rollout"),
    ("coupled", "euler", "land_column_rollout"),
    ("coupled", "heun", "land_column_group_rollout"),
    ("bare_vg_mualem", "heun", "land_column_group_rollout"),
    ("consistent_snow", "heun", "land_column_group_rollout"),
    ("bare", "heun", "land_column_rollout"),
    ("consistent_snow", "euler", "land_column_rollout"),
])
def test_land_rollout_routes_by_type(composition, stepper, source):
    """The land rollout wrappers take their source from the composition's
    type (``land_step.rollout_source``, with no switch): ImplicitEuler and
    Heun over Richards flow, with or without a snowpack, with or without
    vegetation and with either curve and conductivity, the group kernel;
    ``NoFlow`` and ForwardEuler (a snowpack too) the one-thread kernel. The
    land segment VJP routes every composition the same way."""
    from terrarium_tpu_torch.ops import land_vjp as lv

    params = _land_params(composition)
    assert ls.rollout_source(params, stepper) == source
    assert ls.group_scheme(params, stepper) == (source == "land_column_group_rollout")
    assert (lv.vjp_source(params, stepper) == "land_column_group_segment_vjp") == (
        source == "land_column_group_rollout")


@pytest.mark.parametrize("solver,picard_iters", [("cr", 1), ("lu", 2), ("pcr", 0),
                                                 ("thomas", 1.5)])
def test_land_implicit_rollout_refuses_an_unknown_solver(fake_nvcc, solver, picard_iters):
    """``land_column_implicit_rollout`` raises ``ValueError`` for a solver
    other than ``"pcr"`` and ``"thomas"`` or a Picard count that is not a
    positive integer, before any build or launch."""
    params = _land_params("coupled")
    with pytest.raises(ValueError, match="solves by|picard_iters"):
        ls.land_column_implicit_rollout({}, {}, None, None, None, None, None, params, 600.0,
                                        0.0, 1, solver=solver, picard_iters=picard_iters)
    assert fake_nvcc.calls == []


def test_land_rollout_group_size_is_the_group_schemes(fake_nvcc):
    """A group size (``group=``, which the land gradient's forward segments
    pass: the segment VJP's G) is refused by ``ValueError`` for a
    composition the group rollout does not run (``NoFlow``), before any
    build or launch; on CPU tensors it is not read (the plain version), and
    the prebuilt set holds the Thomas entries
    at the VJP's G 8 that the gradient's forward segments launch at float32
    and float64, and the entries with a snowpack that ``chip_smoke.py``
    checks (PCR at float32 and float64; Thomas, the Picard entry and Heun
    at float64), built without contraction (``TAG_FLAGS``)."""
    params = _land_params("veg_noflow")
    with pytest.raises(ValueError, match="group size"):
        ls.land_column_implicit_rollout({}, {}, None, None, None, None, None, params, 600.0,
                                        0.0, 1, group=8)
    assert fake_nvcc.calls == []
    bench = _land_params("coupled").tags
    for dtype in (F32, F64):
        for stepper in (("implicit", "thomas"), ("implicit", "picard")):
            assert ((*stepper, *bench, "g8"), dtype, 20) in \
                cb.INSTANTIATIONS["land_column_group_rollout"]
    snow = _land_params("consistent_snow").tags
    assert snow == bench + ("snow",)
    for source in ("land_column_group_rollout", "land_column_group_segment_vjp"):
        keys = cb.INSTANTIATIONS[source]
        for dtype in (F32, F64):
            assert (("implicit", "pcr", *snow), dtype, 20) in keys
        for stepper in (("implicit", "thomas"), ("implicit", "picard"), ("heun",)):
            assert ((*stepper, *snow), F64, 20) in keys
        assert cb.TAG_FLAGS[source, "snow"] == ("-fmad=false",)
        cb.entry(source, F32, 15, [], tags=("implicit", "pcr", *snow))
        assert "-fmad=false" in fake_nvcc.compiles()[-1]
        assert "-DLAND_SNOW=1" in fake_nvcc.compiles()[-1]
    for source in ("land_column_rollout", "land_column_segment_vjp"):
        assert all("snow" not in t or t[0] not in ("implicit", "heun")
                   for t, _, _ in cb.INSTANTIATIONS[source])


@pytest.mark.parametrize("source,one_thread", [
    ("land_column_group_rollout", "land_column_rollout"),
    ("land_column_group_segment_vjp", "land_column_segment_vjp")])
def test_land_group_heun_keys(fake_nvcc, source, one_thread):
    """The land Heun rollout and segment VJP over the vegetated bench
    composition are prebuilt from the group sources at float32 and float64
    Nz 20 and no longer in the one-thread sources' prebuilt sets, which
    still build the same tags alone on demand (to time one layout against
    the other); an unlisted depth is built alone with Heun's define
    (``SOIL_STEPPER=1``), no solver and no group size, with ``-fmad=false``
    once at float64 and, the group Heun entries' ``TAG_FLAGS`` and the
    one-thread sources' ``FLAGS``, at float32 too, where the group
    ImplicitEuler entries contract."""
    tags = ("heun",) + _land_params("coupled").tags
    for dtype in (F32, F64):
        assert (tags, dtype, 20) in cb.INSTANTIATIONS[source]
    assert all(t != tags for t, _, _ in cb.INSTANTIATIONS[one_thread])
    fn = cb.entry(source, F64, 15, [], tags=tags)
    name = f"{source}_{'_'.join(tags)}_f64_nz15"
    assert fn.name == name
    (compile_,) = fake_nvcc.compiles()
    assert compile_[-1].endswith(f"{source}.cu") and compile_.count("-fmad=false") == 1
    assert _defines(compile_) == {f"-DSOIL_ENTRY={name}", "-DSOIL_T=double", "-DSOIL_NZ=15",
                                  "-DSOIL_STEPPER=1", "-DSOIL_HEAT=0", "-DLAND_RICHARDS=1",
                                  "-DLAND_VEG=1", "-DLAND_CURVE=1", "-DLAND_COND=1"}
    # the group Heun entries contract no multiply-adds at float32 either
    # (TAG_FLAGS), the group ImplicitEuler ones do; the one-thread rollout
    # and segment VJP contract none at float32 (FLAGS: the VJP recomputes
    # the land gradient's one-thread forward segments, ROADMAP C3)
    cb.entry(source, F32, 15, [], tags=tags)
    assert "-fmad=false" in fake_nvcc.compiles()[-1]
    cb.entry(source, F32, 15, [], tags=("implicit", "pcr") + tags[1:])
    assert "-fmad=false" not in fake_nvcc.compiles()[-1]
    one = cb.entry(one_thread, F32, 20, [], tags=tags)
    assert one.name == f"{one_thread}_{'_'.join(tags)}_f32_nz20"
    assert fake_nvcc.compiles()[-1][-1].endswith(f"{one_thread}.cu")
    assert fake_nvcc.compiles()[-1].count("-fmad=false") == 1


def test_land_heun_rollout_group_size_is_the_group_schemes(fake_nvcc):
    """``land_column_heun_rollout`` takes a group size (the land gradient's
    forward segments pass the segment VJP's) and refuses it by
    ``ValueError`` for a composition the group rollout does not run
    (``NoFlow``), before any build or launch."""
    params = _land_params("veg_noflow")
    with pytest.raises(ValueError, match="group size"):
        ls.land_column_heun_rollout({}, {}, None, None, None, None, None, params, 60.0, 0.0, 1,
                                    group=4)
    assert fake_nvcc.calls == []
