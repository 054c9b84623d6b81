"""ERA5 variable registries and standard task definitions.

Names and groupings follow the ECMWF/WeatherBench conventions used by the
reference (graphcast/graphcast.py:50-171, gencast/gencast.py:39-71); they are
data-schema constants, required verbatim for checkpoint and dataset
compatibility.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

PRESSURE_LEVELS_ERA5_37 = (
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225, 250, 300,
    350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800, 825, 850, 875, 900,
    925, 950, 975, 1000)

PRESSURE_LEVELS_HRES_25 = (
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 150, 200, 250, 300, 400, 500, 600,
    700, 800, 850, 900, 925, 950, 1000)

PRESSURE_LEVELS_WEATHERBENCH_13 = (
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)

PRESSURE_LEVELS = {
    13: PRESSURE_LEVELS_WEATHERBENCH_13,
    25: PRESSURE_LEVELS_HRES_25,
    37: PRESSURE_LEVELS_ERA5_37,
}

ALL_ATMOSPHERIC_VARS = (
    "potential_vorticity",
    "specific_rain_water_content",
    "specific_snow_water_content",
    "geopotential",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "specific_humidity",
    "vertical_velocity",
    "vorticity",
    "divergence",
    "relative_humidity",
    "ozone_mass_mixing_ratio",
    "specific_cloud_liquid_water_content",
    "specific_cloud_ice_water_content",
    "fraction_of_cloud_cover",
)

TARGET_SURFACE_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
    "total_precipitation_6hr",
)
TARGET_SURFACE_NO_PRECIP_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
)
GENCAST_TARGET_SURFACE_VARS = (
    "2m_temperature",
    "mean_sea_level_pressure",
    "10m_v_component_of_wind",
    "10m_u_component_of_wind",
    "total_precipitation_12hr",
    "sea_surface_temperature",
)
TARGET_ATMOSPHERIC_VARS = (
    "temperature",
    "geopotential",
    "u_component_of_wind",
    "v_component_of_wind",
    "vertical_velocity",
    "specific_humidity",
)
EXTERNAL_FORCING_VARS = ("toa_incident_solar_radiation",)
GENERATED_FORCING_VARS = (
    "year_progress_sin",
    "year_progress_cos",
    "day_progress_sin",
    "day_progress_cos",
)
FORCING_VARS = EXTERNAL_FORCING_VARS + GENERATED_FORCING_VARS
STATIC_VARS = (
    "geopotential_at_surface",
    "land_sea_mask",
)


@dataclasses.dataclass(frozen=True, eq=True)
class TaskSpec:
  """Which variables a model consumes and predicts.

  Equivalent of the reference's TaskConfig (graphcast/graphcast.py:135-143)
  with input_duration replaced by the explicit frame count.
  """
  input_variables: Tuple[str, ...]
  target_variables: Tuple[str, ...]
  forcing_variables: Tuple[str, ...]
  pressure_levels: Tuple[int, ...]
  num_input_frames: int = 2  # GenCast: current frame + frame 12h prior.


# GenCast's task (gencast/gencast.py:57-71): no precipitation or SST input,
# no TISR forcing, 13 WeatherBench levels, 24h of input at 12h steps.
GENCAST_TASK = TaskSpec(
    input_variables=(
        TARGET_SURFACE_NO_PRECIP_VARS + TARGET_ATMOSPHERIC_VARS
        + GENERATED_FORCING_VARS + STATIC_VARS),
    target_variables=TARGET_SURFACE_NO_PRECIP_VARS + TARGET_ATMOSPHERIC_VARS,
    forcing_variables=GENERATED_FORCING_VARS,
    pressure_levels=PRESSURE_LEVELS_WEATHERBENCH_13,
    num_input_frames=2,
)

# Full GenCast task with precipitation + SST (paper scale).
GENCAST_TASK_FULL = TaskSpec(
    input_variables=(
        tuple(v for v in GENCAST_TARGET_SURFACE_VARS
              if v != "total_precipitation_12hr")
        + TARGET_ATMOSPHERIC_VARS + GENERATED_FORCING_VARS + STATIC_VARS),
    target_variables=GENCAST_TARGET_SURFACE_VARS + TARGET_ATMOSPHERIC_VARS,
    forcing_variables=GENERATED_FORCING_VARS,
    pressure_levels=PRESSURE_LEVELS_WEATHERBENCH_13,
    num_input_frames=2,
)

# GraphCast deterministic task, 13 levels (graphcast/graphcast.py:157-164).
GRAPHCAST_TASK_13 = TaskSpec(
    input_variables=(
        TARGET_SURFACE_VARS + TARGET_ATMOSPHERIC_VARS + FORCING_VARS
        + STATIC_VARS),
    target_variables=TARGET_SURFACE_VARS + TARGET_ATMOSPHERIC_VARS,
    forcing_variables=FORCING_VARS,
    pressure_levels=PRESSURE_LEVELS_WEATHERBENCH_13,
    num_input_frames=2,
)

# GraphCast at the full 37 ERA5 levels.
GRAPHCAST_TASK_37 = dataclasses.replace(
    GRAPHCAST_TASK_13, pressure_levels=PRESSURE_LEVELS_ERA5_37)

# Precipitation predicted but not consumed (graphcast/graphcast.py:165-171):
# for datasets whose precip analysis is unreliable as an input.
GRAPHCAST_TASK_13_PRECIP_OUT = dataclasses.replace(
    GRAPHCAST_TASK_13,
    input_variables=(
        TARGET_SURFACE_NO_PRECIP_VARS + TARGET_ATMOSPHERIC_VARS
        + FORCING_VARS + STATIC_VARS),
)

TASKS = {
    'gencast': GENCAST_TASK,
    'gencast_full': GENCAST_TASK_FULL,
    'graphcast_13': GRAPHCAST_TASK_13,
    'graphcast_37': GRAPHCAST_TASK_37,
    'graphcast_13_precip_out': GRAPHCAST_TASK_13_PRECIP_OUT,
}


def is_atmospheric(name: str) -> bool:
  return name in ALL_ATMOSPHERIC_VARS


def is_static(name: str) -> bool:
  return name in STATIC_VARS
