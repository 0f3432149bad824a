"""The soil column rollout: a hand-written CUDA kernel, its plain PyTorch
version and the wrapper that picks between them by device.

``soil_column_rollout`` applies ``ForwardEuler.pre_closure_step`` ``n``
times to the live carry of the main-path :class:`SoilModel` (internal energy,
saturation, surface pool) and returns the new carry. It replaces
``terrarium_tpu/ops/fused_step.py::make_fused_lean_rollout`` for that
configuration. The CUDA source is ``csrc/soil_column_rollout.cu``; it is
compiled with ``nvcc`` at first use into ``_build/`` beside this package and
loaded with ctypes.

On CPU tensors the wrapper runs :func:`soil_column_rollout_plain`; on CUDA
tensors it launches the kernel or raises. Each launch adds one to
``soil_column_rollout.launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from .fastpow import fast_pow, pow_code
from ..processes.soil.swrc import one_minus_eps
from ..utils.utils import safediv

__all__ = ["ColumnParams", "build_kernel", "soil_column_rollout",
           "soil_column_rollout_plain", "SUPPORTED_NZ"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "soil_column_rollout.cu"
_BUILD_DIR = _PKG / "_build"

#: vertical sizes the kernel is instantiated for (the golden and bench grids)
SUPPORTED_NZ = (20, 30)


@dataclasses.dataclass(frozen=True)
class ColumnParams:
    """Scalar parameters of the fused soil step, as Python floats.

    Products of two parameters that the JAX package forms in Python (a
    constituent property times a solid-matrix fraction) are formed here the
    same way, so the kernel and the plain version see the same numbers."""

    por: float
    L: float
    c_water: float
    c_ice: float
    c_air: float
    c_mineral: float
    c_organic: float
    sk_water: float
    sk_ice: float
    sk_air: float
    sk_mineral: float
    sk_organic: float
    theta_res: float
    vg_span: float
    neg_inv_alpha: float
    psi_min: float
    vg_se_lo: float
    vg_se_hi: float
    K_sat: float
    neg_impedance: float
    k_theta_sat: float
    k_se_hi: float
    eps_lo: float
    z_top: float
    p_inv_m: float
    p_inv_n: float
    p_k1: float
    p_k2: float

    @staticmethod
    def of(model, dtype: torch.dtype) -> "ColumnParams":
        soil = model.soil
        strat, bgc = soil.strat, soil.biogeochem
        props = soil.energy.thermal_properties
        hyd = soil.hydrology.hydraulic_properties
        swrc, unsat = hyd.swrc, hyd.unsat_hydraulic_cond
        c = model.constants
        por = strat.bulk_porosity(bgc)
        organic = strat.organic_fraction(bgc)
        solid = 1.0 - por
        mineral_frac, organic_frac = solid * (1.0 - organic), solid * organic
        cs, ks = props.heat_capacities, props.conductivities
        n = swrc.n
        m = 1.0 - 1.0 / n
        return ColumnParams(
            por=por, L=c.rho_w * c.L_sl,
            c_water=cs.water, c_ice=cs.ice, c_air=cs.air,
            c_mineral=cs.mineral * mineral_frac, c_organic=cs.organic * organic_frac,
            sk_water=math.sqrt(ks.water), sk_ice=math.sqrt(ks.ice),
            sk_air=math.sqrt(ks.air),
            sk_mineral=math.sqrt(ks.mineral) * mineral_frac,
            sk_organic=math.sqrt(ks.organic) * organic_frac,
            theta_res=swrc.theta_res, vg_span=por - swrc.theta_res,
            neg_inv_alpha=-(1.0 / swrc.alpha), psi_min=swrc.psi_min,
            vg_se_lo=1e-8, vg_se_hi=one_minus_eps(dtype, 1e-12),
            K_sat=hyd.sat_hydraulic_cond, neg_impedance=-unsat.impedance,
            k_theta_sat=max(por, 1e-12), k_se_hi=one_minus_eps(dtype, 1e-9),
            eps_lo=float(torch.finfo(dtype).eps),
            z_top=float(model.grid.vertical.z_faces[-1]),
            p_inv_m=-1.0 / m, p_inv_n=1.0 / n, p_k1=n / (n + 1.0), p_k2=(n - 1.0) / n)


class _CParams(ctypes.Structure):
    """C layout of ``SoilColumnParams`` in the CUDA source."""

    _fields_ = ([(f.name, ctypes.c_double) for f in dataclasses.fields(ColumnParams)]
                + [(name, ctypes.c_int) for name in (
                    "num_inv_m", "den_inv_m", "num_inv_n", "den_inv_n",
                    "num_k1", "den_k1", "num_k2", "den_k2")])

    @staticmethod
    def of(p: ColumnParams) -> "_CParams":
        codes = {}
        for key in ("inv_m", "inv_n", "k1", "k2"):
            codes["num_" + key], codes["den_" + key] = pow_code(getattr(p, "p_" + key))
        return _CParams(**dataclasses.asdict(p), **codes)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------
def _plain_step(U, sat, S, vtop, dz, dzf, zc, zf, p: ColumnParams, dt):
    """One ``pre_closure_step`` in the kernel's order of operations: the
    sweeps row by row, everything else elementwise over ``(Nz, cells)``."""
    nz = U.shape[0]
    # closure: saturation adjustment, up sweep then down sweep
    rows, dzr = sat.unbind(0), dz.unbind(0)
    c = torch.zeros_like(S)
    up = []
    for k in range(nz):
        up.append(torch.clamp(rows[k] + c / dzr[k], max=1.0))
        c = torch.clamp((rows[k] - 1.0) * dzr[k] + c, min=0.0)
    S = S + c
    c2 = torch.zeros_like(S)
    wt = torch.broadcast_to(zf[nz], S.shape)
    new = [None] * nz
    for k in reversed(range(nz)):
        new[k] = torch.clamp(up[k] - c2 / dzr[k], min=0.0)
        c2 = torch.clamp(-up[k] * dzr[k] + c2, min=0.0)
        wt = torch.where(new[k] < 1.0, zf[k], wt)
    sat = torch.stack(new)

    # energy closure, heat capacity and bulk conductivity
    L_theta = p.L * sat * p.por
    negL = -L_theta
    liq = torch.where(U >= 0.0, 1.0,
                      torch.where(U >= negL, 1.0 - safediv(U, negL), 0.0))
    wi = sat * p.por
    water, ice, air = wi * liq, wi * (1.0 - liq), (1.0 - sat) * p.por
    C = p.c_water * water + p.c_ice * ice + p.c_air * air + p.c_mineral + p.c_organic
    T = torch.where(U < negL, (U + L_theta) / C, torch.where(U >= 0.0, U / C, 0.0))
    acc = p.sk_water * water + p.sk_ice * ice + p.sk_air * air + p.sk_mineral + p.sk_organic
    kap = acc * acc

    # centre hydraulic conductivity
    I_ice = 10.0 ** (p.neg_impedance * (1.0 - liq))
    se = torch.clamp(water / p.k_theta_sat, 0.0, 1.0)
    frozen = se <= p.eps_lo
    se_s = torch.where(frozen, p.eps_lo, torch.clamp(se, max=p.k_se_hi))
    inner = 1.0 - fast_pow(1.0 - fast_pow(se_s, p.p_k1), p.p_k2)
    K_unsat = torch.where(frozen, 0.0, p.K_sat * I_ice * torch.sqrt(se_s) * (inner * inner))
    Kc = torch.where(se >= 1.0, p.K_sat * I_ice, K_unsat)

    # heat flux: zero gradient at the bottom, Dirichlet ghost at the top
    T_lo = torch.cat([T[:1], T])
    T_hi = torch.cat([T, 2.0 * vtop - T[-1:]])
    k_lo = torch.cat([kap[:1], kap])
    k_hi = torch.cat([kap, kap[-1:]])
    qh = -(0.5 * (k_hi + k_lo)) * ((T_hi - T_lo) / dzf)
    U = U + (-((qh[1:] - qh[:-1]) / dz)) * dt

    # pressure head and Darcy flux with upwind-min face conductivity
    se_v = (sat * p.por - p.theta_res) / p.vg_span
    ss = torch.clamp(se_v, p.vg_se_lo, p.vg_se_hi)
    psi = p.neg_inv_alpha * fast_pow(fast_pow(ss, p.p_inv_m) - 1.0, p.p_inv_n)
    psi_m = torch.where(se_v >= 1.0, 0.0, torch.clamp(psi, min=p.psi_min))
    psi = torch.clamp(wt - zc, min=0.0) + psi_m + (zc - p.z_top)
    grad = (torch.cat([psi, psi[-1:]]) - torch.cat([psi[:1], psi])) / dzf
    Kf = torch.cat([Kc[:1], torch.minimum(Kc[:-2], Kc[1:-1]), Kc[-1:], Kc[-1:]])
    inf = torch.full_like(Kf[:1], torch.inf)
    K_eff = torch.where(grad < 0.0, torch.minimum(torch.cat([inf, Kf[:-1]]), Kf),
                        torch.minimum(Kf, torch.cat([Kf[1:], inf])))
    qw = -K_eff * grad
    sat = sat + ((-((qw[1:] - qw[:-1]) / dz)) / p.por) * dt
    S = S + torch.minimum(torch.zeros_like(S), S) * dt
    return U, sat, S


def soil_column_rollout_plain(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                              params: ColumnParams, dt: float):
    """Plain PyTorch version of the kernel: ``len(top_T)`` steps, where
    ``top_T[i]`` is the top temperature BC (a scalar or ``(cells,)``) of
    step ``i``. Coordinates are 1-D tensors in the fields' dtype."""
    dz2, dzf2 = dz[:, None], dz_faces[:, None]
    zc2, zf2 = z_centers[:, None], z_faces[:, None]
    for i in range(top_T.shape[0]):
        U, sat, S = _plain_step(U, sat, S, top_T[i], dz2, dzf2, zc2, zf2, params, dt)
    return U, sat, S


# ---------------------------------------------------------------------------
# kernel build and launch
# ---------------------------------------------------------------------------
_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the soil column kernel "
                           "is built from csrc/soil_column_rollout.cu at first use")
    return found


def build_kernel() -> ctypes.CDLL:
    """Compile (once per source version) and load the kernel library.

    The library goes to ``_build/soil_column_rollout-<hash>.so``; ptxas's
    register and spill report is kept beside it as ``.ptxas.txt``."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
        so = _BUILD_DIR / f"soil_column_rollout-{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                out = pathlib.Path(tmp) / so.name
                cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                       "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                       "-o", str(out), str(_SOURCE)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
                (_BUILD_DIR / f"soil_column_rollout-{digest}.ptxas.txt").write_text(res.stderr)
                os.replace(out, so)
        lib = ctypes.CDLL(str(so))
        argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4
                    + [ctypes.POINTER(_CParams), ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_longlong, ctypes.c_void_p])
        for name in ("soil_column_rollout_f32", "soil_column_rollout_f64"):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def ptxas_report() -> str:
    """ptxas's ``-v`` output of the current build ('' before the build)."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    path = _BUILD_DIR / f"soil_column_rollout-{digest}.ptxas.txt"
    return path.read_text() if path.exists() else ""


def _check_inputs(U, sat, S, top_T, coords):
    nz, cells = U.shape
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"soil column rollout takes float32 or float64, got {U.dtype}")
    for name, t, shape in (("saturation", sat, (nz, cells)), ("surface pool", S, (cells,)),
                           ("dz", coords[0], (nz,)), ("dz_faces", coords[1], (nz + 1,)),
                           ("z_centers", coords[2], (nz,)), ("z_faces", coords[3], (nz + 1,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for t in (U, sat, S, top_T, *coords):
        if t.dtype != U.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {U.dtype}")
        if t.device != U.device:
            raise ValueError(f"device mismatch: {t.device} vs {U.device}")
    if top_T.dim() not in (1, 2) or (top_T.dim() == 2 and top_T.shape[1] != cells):
        raise ValueError(f"top temperature table must be (n,) or (n, {cells}), "
                         f"got {tuple(top_T.shape)}")


def soil_column_rollout(U, sat, S, top_T, dz, dz_faces, z_centers, z_faces,
                        params: ColumnParams, dt: float):
    """``len(top_T)`` fused soil steps on the live carry; returns new
    ``(U, sat, S)``. ``top_T`` is ``(n,)`` or ``(n, cells)`` (strides may be
    0). CPU tensors take the plain version; CUDA tensors launch the kernel."""
    coords = (dz, dz_faces, z_centers, z_faces)
    _check_inputs(U, sat, S, top_T, coords)
    if U.device.type == "cpu":
        return soil_column_rollout_plain(U, sat, S, top_T, *coords, params, dt)
    if U.device.type != "cuda":
        raise ValueError(f"soil column rollout runs on cpu or cuda, not {U.device}")
    nz, cells = U.shape
    if nz not in SUPPORTED_NZ:
        raise ValueError(f"the soil column kernel is built for Nz in {SUPPORTED_NZ}, got {nz}")
    for name, t in (("energy", U), ("saturation", sat), ("surface pool", S),
                    *(("coordinate", c) for c in coords)):
        if not t.is_contiguous():
            raise ValueError(f"{name} tensor must be contiguous")
    lib = build_kernel()
    U_out, sat_out, S_out = torch.empty_like(U), torch.empty_like(sat), torch.empty_like(S)
    steps = top_T.shape[0]
    step_stride = top_T.stride(0)
    cell_stride = top_T.stride(1) if top_T.dim() == 2 else 0
    fn = (lib.soil_column_rollout_f32 if U.dtype == torch.float32
          else lib.soil_column_rollout_f64)
    cparams = _CParams.of(params)
    err = fn(U.data_ptr(), sat.data_ptr(), S.data_ptr(), U_out.data_ptr(),
             sat_out.data_ptr(), S_out.data_ptr(), top_T.data_ptr(), step_stride,
             cell_stride, *(c.data_ptr() for c in coords), ctypes.byref(cparams), nz,
             steps, float(dt), cells, torch.cuda.current_stream(U.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"soil column kernel launch failed: cudaError {err}")
    soil_column_rollout.launches += 1
    return U_out, sat_out, S_out


soil_column_rollout.launches = 0
