"""terrarium_tpu_torch — the PyTorch and CUDA port of terrarium_tpu.

A :class:`SoilModel` with two-phase heat conduction and the free-water
freeze curve, either heat only (``NoFlow``, the default, as in the JAX
package) or with Richards-equation hydrology, stepped by ForwardEuler, Heun
or ImplicitEuler (tridiagonal solves by PCR or Thomas), with the top
temperature given as a value, ``f(t)`` or an input variable fed by
``FieldInputSource`` / ``TimeSeriesInputSource``; and the coupled
:class:`LandModel` (atmosphere, surface energy balance, surface hydrology,
PALADYN vegetation over that soil, and an optional degree-day
:class:`Snowpack`), stepped by ForwardEuler, Heun or ImplicitEuler; the
standalone :class:`VegetationModel` and :class:`SurfaceEnergyModel`.
``Simulation.run`` goes through
hand-written CUDA column kernels on an NVIDIA Hopper card and through their
plain PyTorch version on the CPU (``ops/fused_step.py``, ``ops/land_step.py``)
for the compositions those take, and through the process modules for any
other (other BCs, forcings, other steppers); one full step of the whole
state through a CUDA kernel is ``ops/fused_step.make_fused_step``; gradients
through a CUDA segment-VJP kernel (``timesteppers/fused_grad.py``). A long
forcing streams from the host window by window through
:class:`ChunkedForcingPipeline` (``io/forcing_pipeline.py``); the
repository's probes are in ``experiments/``.

Tensors are ``(Nz, cells)`` with ``k = 0`` the bottom layer, as in the JAX
package; the grid carries the dtype and device. The package imports torch
and never JAX.
"""

__version__ = "0.1.0"

from .constants import (PhysicalConstants, compute_vpd, partial_pressure_CO2,
                        partial_pressure_O2, saturation_vapor_pressure, stefan_boltzmann,
                        vapor_pressure_to_specific_humidity)
from .variables import XY, XYZ, Variable, Variables, auxiliary, input, prognostic
from .state import Clock, State, build_state, reset_tendencies
from .grids.spacing import ExponentialSpacing, UniformSpacing
from .grids.vertical import VerticalGrid
from .grids.column import ColumnGrid
from .ops.bcs import Dirichlet, Flux, InputRef, Neumann, NoFlux, merge_boundary_conditions
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
from .processes.atmosphere import (AmbientCO2, ConstantAerodynamics, LongShortWaveRadiation,
                                   MoninObukhovAerodynamics, PrescribedAtmosphere, RainSnow,
                                   SpecificHumidity, TracerGas)
from .processes.surface_energy.seb import (ConstantAlbedo, DiagnosedRadiativeFluxes,
                                           DiagnosedTurbulentFluxes, ImplicitSkinTemperature,
                                           PrescribedAlbedo, PrescribedRadiativeFluxes,
                                           PrescribedSkinTemperature, PrescribedTurbulentFluxes,
                                           SurfaceEnergyBalance)
from .processes.surface_hydrology.surface_hydrology import (
    BareGroundEvaporation, ConstantEvaporationResistanceFactor, DirectSurfaceRunoff,
    NoCanopyInterception, PALADYNCanopyEvapotranspiration, PALADYNCanopyInterception,
    SoilMoistureResistanceFactor, SurfaceHydrology)
from .processes.vegetation.vegetation import (
    FieldCapacityLimitedPAW, LUEPhotosynthesis, MedlynStomatalConductance,
    PALADYNAutotrophicRespiration, PALADYNCarbonDynamics, PALADYNPhenology,
    PALADYNVegetationDynamics, StaticExponentialRootDistribution, VegetationCarbon)
from .models.boundary_conditions import (FreeDrainage, GeothermalHeatFlux, GroundHeatFlux,
                                         ImpermeableBoundary, InfiltrationFlux,
                                         PrescribedBottomTemperature,
                                         PrescribedSurfaceTemperature)
from .models.initializers import (ConstantSaturation, ConstantSoilTemperature,
                                  DefaultInitializer, PiecewiseLinearInitialSoilTemperature,
                                  QuasiThermalSteadyState, SaturationWaterTable, SoilInitializer)
from .models.soil_model import SoilModel
from .models.land_model import LandModel
from .models.vegetation_model import SurfaceEnergyModel, VegetationModel
from .processes.snow import SnowCoverAlbedo, Snowpack
from .io.input_sources import FieldInputSource, TimeSeriesInputSource
from .timesteppers.stepping import ForwardEuler, Heun
from .timesteppers.implicit import ImplicitEuler
from .timesteppers.integrator import Simulation, initialize
from .io.forcing_pipeline import ChunkedForcingPipeline
