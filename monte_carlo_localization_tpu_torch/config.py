"""Typed configuration for the PyTorch/CUDA MCL engine.

The same :class:`MCLConfig` fields, defaults and YAML handling as the JAX
package's ``monte_carlo_localization_tpu/config.py``, so one
``config/mcl_config.yaml`` drives both packages: the reference's ROS2
``particle_filter: ros__parameters:`` nesting is accepted, and its
vestigial keys (``range_method``, ``theta_discretization``, ...) are
tolerated and ignored.

Fields that select TPU-only options (``pallas_*``, ``sharded_*``,
``scan_unroll``) are kept so a config file stays valid for both packages;
the port rejects the options it has not ported when a filter is built.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import yaml

# Keys the reference YAML carries but its node never reads; accepted and
# ignored.
VESTIGIAL_KEYS = frozenset(
    {
        "range_method",
        "theta_discretization",
        "rangelib_variant",
        "fine_timing",
        "map_frame",
        "base_frame",
        "laser_frame",
        "sim_mode",
    }
)

@dataclass(frozen=True)
class MCLConfig:
    """All engine parameters; field for field the JAX package's MCLConfig."""

    # --- core ---
    angle_step: int = 18  # lidar downsample stride
    max_particles: int = 2000
    max_viz_particles: int = 60
    squash_factor: float = 2.2  # likelihood ^= 1/squash_factor
    max_range: float = 12.0  # meters
    max_pose_range: float = 10000.0
    delay_compensation_factor: float = 1.5

    # --- sensor model (4-component beam model) ---
    z_hit: float = 0.80
    z_short: float = 0.01
    z_max: float = 0.07
    z_rand: float = 0.12
    sigma_hit: float = 8.0  # in PIXELS

    # --- motion model noise (std-dev, per step) ---
    motion_dispersion_x: float = 0.05
    motion_dispersion_y: float = 0.025
    motion_dispersion_theta: float = 0.25

    # --- robot geometry ---
    lidar_offset_x: float = 0.0
    lidar_offset_y: float = 0.0
    wheelbase: float = 0.325

    # --- runtime / io ---
    scan_topic: str = "/scan"
    odom_topic: str = "/odom"
    publish_odom: bool = True
    viz: bool = True
    timer_frequency: float = 100.0

    # --- engine knobs ---
    use_parallel_raycasting: bool = True
    num_threads: int = 0
    # "auto" and "lut_pallas" both select the fused LUT likelihood (the
    # CUDA kernel on a card, its plain PyTorch version on the CPU); "lut"
    # reads a dense lut_theta_bins LUT per ray, "sphere" and "dda" march
    # every ray (filter/core.py sensor_update_px).
    raycast_method: str = "auto"
    sphere_march_iters: int = 48
    lut_theta_bins: int = 1440
    sensor_model_mode: str = "analytic"  # "analytic" | "table"
    # TPU kernel options of the JAX package, served by the port's CUDA
    # kernels: pallas_block is the unique-window kernel's particles per
    # block (0: filter/core.py DEDUP_BLOCK); pallas_dedup_slots S > 0 turns
    # that kernel on (0 and -1 are off); pallas_dedup_matmul runs the same
    # kernel and needs S in 1..128; pallas_subbin is the sub-bin heading
    # lerp; pallas_mega the one-launch step (filter/mega.py).
    pallas_block: int = 0
    pallas_dedup_slots: int = 0
    pallas_dedup_matmul: bool = False
    pallas_subbin: bool = False
    pallas_mega: bool = False
    sharded_resample: str = "bucketed"
    sharded_fringe: int = 0
    resample_method: str = "systematic"  # "systematic" | "multinomial"
    exact_dt_heuristic: bool = True  # reference dt reconstruction
    async_correction: bool = False
    async_depth: int = 4
    live_chunk: int = 1
    # the JAX step_many's lax.scan unroll; accepted for the JAX configs' sake,
    # with no counterpart: a CUDA graph of a chunk is fully unrolled
    # (tools/perf_ablate.py --unroll sweeps the corrections per replay)
    scan_unroll: int = 1
    dtype: str = "float32"
    seed: int = 0

    # --- automatic re-localization (Augmented MCL monitor) ---
    auto_reinit: bool = False
    reinit_mode: str = "reinit"
    reinit_alpha_slow: float = 0.05
    reinit_alpha_fast: float = 0.40
    reinit_ratio_threshold: float = 0.25
    reinit_patience: int = 10
    reinit_min_iters: int = 30
    reinit_cooldown: int = 50
    reinit_inject_max: float = 0.3
    reinit_inject_gain: float = 1.0

    # --- map ---
    map_name: str = "sibal1"
    map_dir: str = ""

    @property
    def inv_squash_factor(self) -> float:
        return 1.0 / self.squash_factor

    def max_range_px(self, resolution: float) -> int:
        """MAX_RANGE_PX = max_range / map_resolution."""
        return int(self.max_range / resolution)

    def replace(self, **kw: Any) -> "MCLConfig":
        return dataclasses.replace(self, **kw)


def resolve_raycast_method(method: str) -> str:
    """Map a configured raycast method to the one the port runs.

    ``"auto"`` and ``"lut_pallas"`` resolve to ``"lut_pallas"`` on every
    device: the likelihood wrapper picks the CUDA kernel or its plain
    version from the tensors' device (the JAX package resolves ``auto``
    to ``lut`` on its CPU backend). ``"lut"``, ``"sphere"`` and ``"dda"``
    pass through; anything else raises ``ValueError``.
    """
    if method in ("auto", "lut_pallas"):
        return "lut_pallas"
    if method in ("lut", "sphere", "dda"):
        return method
    raise ValueError(f"Unknown raycast method: {method!r}")


_FIELD_NAMES = {f.name for f in dataclasses.fields(MCLConfig)}


def _coerce(name: str, value: Any) -> Any:
    """Coerce YAML scalars to the dataclass field types."""
    for f in dataclasses.fields(MCLConfig):
        if f.name != name:
            continue
        ftype = f.type if isinstance(f.type, str) else f.type.__name__
        if ftype == "int":
            return int(value)
        if ftype == "float":
            return float(value)
        if ftype == "bool":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes", "on")
            return bool(value)
        if ftype == "str":
            return str(value)
    return value


def config_from_dict(params: Mapping[str, Any], strict: bool = False) -> MCLConfig:
    """Build an :class:`MCLConfig` from a flat parameter mapping; unknown
    keys are tolerated unless ``strict``."""
    kw: dict[str, Any] = {}
    for key, value in params.items():
        if key in _FIELD_NAMES:
            kw[key] = _coerce(key, value)
        elif key in VESTIGIAL_KEYS:
            continue
        elif strict:
            raise KeyError(f"Unknown MCL config key: {key!r}")
    return MCLConfig(**kw)


def load_config(path: str | Path, strict: bool = False) -> MCLConfig:
    """Load a config YAML in the reference's schema, nested ROS2 layout
    (``particle_filter: ros__parameters:`` plus ``map_server``) or flat."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}

    params: dict[str, Any] = {}
    if "particle_filter" in raw and isinstance(raw["particle_filter"], dict):
        params.update(raw["particle_filter"].get("ros__parameters", {}) or {})
    else:
        params.update({k: v for k, v in raw.items() if k not in ("map_server",)})

    map_section = raw.get("map_server", {})
    if isinstance(map_section, dict):
        ros_params = map_section.get("ros__parameters", map_section)
        if isinstance(ros_params, dict) and "map" in ros_params:
            params["map_name"] = ros_params["map"]

    return config_from_dict(params, strict=strict)
