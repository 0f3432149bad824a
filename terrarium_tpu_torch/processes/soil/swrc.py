"""Soil water retention curves: Van Genuchten and Brooks-Corey
(counterpart of ``terrarium_tpu/processes/soil/swrc.py``)."""
from __future__ import annotations

import dataclasses

import torch

from ...ops.fastpow import fast_pow

__all__ = ["VanGenuchten", "BrooksCorey", "one_minus_eps"]


def one_minus_eps(dtype: torch.dtype, floor: float) -> float:
    """Upper clip ``1 - eps`` for effective saturation that survives the
    dtype: ``eps = max(floor, 64 * eps(dtype))`` (about 7.6e-6 in float32;
    in float64 ``floor`` wins)."""
    return 1.0 - max(float(floor), 64.0 * float(torch.finfo(dtype).eps))


@dataclasses.dataclass(frozen=True)
class VanGenuchten:
    """Van Genuchten (1980): theta(psi) = theta_res + (theta_sat - theta_res)
    * (1 + (-alpha*psi)^n)^(-m) for psi < 0, with m = 1 - 1/n. ``psi_min``
    clamps the inverse in fully drained cells."""

    alpha: float = 4.0  # inverse air-entry suction [1/m]
    n: float = 2.0  # pore-size distribution index
    theta_res: float = 0.0  # residual water content
    psi_min: float = -1.0e4  # lower clamp of the inverse [m]

    def __call__(self, psi, theta_sat):
        m = 1.0 - 1.0 / self.n
        psi_neg = torch.clamp(psi, max=0.0)
        theta_unsat = self.theta_res + (theta_sat - self.theta_res) * fast_pow(
            1.0 + fast_pow(-self.alpha * psi_neg, self.n), -m)
        return torch.where(psi < 0.0, theta_unsat, theta_sat)

    def inverse(self, theta, theta_sat):
        """Matric head psi_m(theta); 0 at and above saturation."""
        m = 1.0 - 1.0 / self.n
        se = (theta - self.theta_res) / (theta_sat - self.theta_res)
        se_safe = torch.clamp(se, 1e-8, one_minus_eps(theta.dtype, 1e-12))
        psi = -(1.0 / self.alpha) * fast_pow(
            fast_pow(se_safe, -1.0 / m) - 1.0, 1.0 / self.n)
        psi = torch.clamp(psi, min=self.psi_min)
        return torch.where(se >= 1.0, 0.0, psi)

    def inverse_deriv(self, theta, theta_sat, clamp=1.0e6):
        """d(psi_m)/d(theta), clamped to ``[0, clamp]``; 0 at and above
        saturation (the implicit stepper's Jacobian)."""
        m = 1.0 - 1.0 / self.n
        dth = theta_sat - self.theta_res
        se = torch.clamp((theta - self.theta_res) / dth, 1e-6, one_minus_eps(theta.dtype, 1e-9))
        core = fast_pow(se, -1.0 / m) - 1.0
        dpsi_dse = (1.0 / (self.alpha * self.n * m)) \
            * fast_pow(core, (1.0 - self.n) / self.n) \
            * fast_pow(se, -(1.0 + m) / m)
        d = dpsi_dse / dth
        saturated = (theta - self.theta_res) / dth >= 1.0
        return torch.where(saturated, 0.0, torch.clamp(d, 0.0, clamp))


@dataclasses.dataclass(frozen=True)
class BrooksCorey:
    """Brooks & Corey (1964): theta(psi) = theta_res + (theta_sat -
    theta_res) * (psi_s / -psi)^lam for psi < -psi_s, theta_sat otherwise;
    ``psi_s`` is the (positive) air-entry suction [m]."""

    psi_s: float = 0.01  # air-entry suction [m]
    lam: float = 0.2  # pore-size distribution index
    theta_res: float = 0.0
    psi_min: float = -1.0e4  # lower clamp of the inverse [m]

    def __call__(self, psi, theta_sat):
        psi_safe = torch.clamp(psi, max=-self.psi_s)
        theta_unsat = self.theta_res + (theta_sat - self.theta_res) * fast_pow(
            self.psi_s / -psi_safe, self.lam)
        return torch.where(psi < -self.psi_s, theta_unsat, theta_sat)

    def inverse(self, theta, theta_sat):
        """Matric head psi_m(theta); 0 at and above saturation."""
        se = (theta - self.theta_res) / (theta_sat - self.theta_res)
        se = torch.clamp(se, 1e-8, 1.0)
        psi = -self.psi_s * fast_pow(se, -1.0 / self.lam)
        psi = torch.clamp(psi, min=self.psi_min)
        return torch.where(se >= 1.0, 0.0, psi)

    def inverse_deriv(self, theta, theta_sat, clamp=1.0e6):
        """d(psi_m)/d(theta), clamped to ``[0, clamp]``; 0 at and above
        saturation."""
        dth = theta_sat - self.theta_res
        se_raw = (theta - self.theta_res) / dth
        se = torch.clamp(se_raw, 1e-6, 1.0)
        d = (self.psi_s / self.lam) * fast_pow(se, -1.0 / self.lam - 1.0) / dth
        return torch.where(se_raw >= 1.0, 0.0, torch.clamp(d, 0.0, clamp))
