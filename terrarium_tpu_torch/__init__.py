"""terrarium_tpu_torch — the PyTorch and CUDA port of terrarium_tpu.

A :class:`SoilModel` with two-phase heat conduction and the free-water
freeze curve, either heat only (``NoFlow``, the default, as in the JAX
package) or with Richards-equation hydrology, stepped by ForwardEuler, Heun
or ImplicitEuler (tridiagonal solves by PCR or Thomas), with the top
temperature given as a value, ``f(t)`` or an input variable fed by
``FieldInputSource`` / ``TimeSeriesInputSource``.
``Simulation.run`` goes through hand-written CUDA column kernels on an NVIDIA
Hopper card and through their plain PyTorch version on the CPU
(``ops/fused_step.py``); gradients through a CUDA segment-VJP kernel
(``timesteppers/fused_grad.py``).

Tensors are ``(Nz, cells)`` with ``k = 0`` the bottom layer, as in the JAX
package; the grid carries the dtype and device. The package imports torch
and never JAX.
"""

__version__ = "0.1.0"

from .constants import PhysicalConstants
from .variables import XY, XYZ, Variable, Variables, auxiliary, input, prognostic
from .state import Clock, State, build_state, reset_tendencies
from .grids.spacing import ExponentialSpacing, UniformSpacing
from .grids.vertical import VerticalGrid
from .grids.column import ColumnGrid
from .ops.bcs import Dirichlet, Flux, Neumann, merge_boundary_conditions
from .processes.base import Context
from .processes.soil.stratigraphy import (ConstantSoilCarbonDensity, ConstantSoilPorosity,
                                          HomogeneousStratigraphy, SoilTexture, SoilVolume,
                                          volumetric_fractions)
from .processes.soil.thermal import (FreeWater, InverseQuadratic, SoilHeatCapacities,
                                     SoilThermalConductivities, SoilThermalProperties)
from .processes.soil.energy import SoilEnergyBalance, SoilEnergyTemperatureClosure
from .processes.soil.swrc import BrooksCorey, VanGenuchten
from .processes.soil.hydraulics import (ConstantSoilHydraulics, SoilHydraulicsSURFEX,
                                         UnsatKLinear, UnsatKVanGenuchten)
from .processes.soil.hydrology import (NoFlow, RichardsEq, SoilHydrology,
                                       SoilSaturationPressureClosure)
from .processes.soil.soil_coupled import SoilEnergyWaterCarbon
from .models.boundary_conditions import PrescribedSurfaceTemperature
from .models.initializers import DefaultInitializer
from .models.soil_model import SoilModel
from .io.input_sources import FieldInputSource, TimeSeriesInputSource
from .timesteppers.stepping import ForwardEuler, Heun
from .timesteppers.implicit import ImplicitEuler
from .timesteppers.integrator import Simulation, initialize
