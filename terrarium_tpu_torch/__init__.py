"""terrarium_tpu_torch — the PyTorch and CUDA port of terrarium_tpu.

This slice runs the main path: a :class:`SoilModel` with two-phase heat
conduction, the free-water freeze curve and Richards-equation hydrology,
stepped by Forward Euler. ``Simulation.run`` goes through a hand-written CUDA
column kernel on an NVIDIA Hopper card and through its plain PyTorch version
on the CPU (``ops/fused_step.py``).

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
from .processes.soil.swrc import VanGenuchten
from .processes.soil.hydraulics import ConstantSoilHydraulics, UnsatKVanGenuchten
from .processes.soil.hydrology import (RichardsEq, SoilHydrology,
                                       SoilSaturationPressureClosure)
from .processes.soil.soil_coupled import SoilEnergyWaterCarbon
from .models.boundary_conditions import PrescribedSurfaceTemperature
from .models.initializers import DefaultInitializer
from .models.soil_model import SoilModel
from .timesteppers.stepping import ForwardEuler
from .timesteppers.integrator import Simulation, initialize
