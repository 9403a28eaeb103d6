"""The MCL correction in PyTorch, as in the JAX package's
``filter/core.py``:

    systematic resample -> motion -> likelihood
    -> log-quality and max-shift normalization -> weighted-mean pose

The likelihood is the fused LUT kernel (``raycast_method`` ``lut_pallas``,
the default) or :func:`sensor_update`: a ray cast per (particle, beam) by
``sphere``, ``dda`` or ``lut`` and the beam model, analytic or tabled.

With ``inject_fraction`` (Augmented MCL) each particle is replaced, after
motion and before the likelihood, by a uniform free-space draw with that
probability.

On a card :meth:`ParticleFilter.step`, its injection twin and
:meth:`ParticleFilter.step_many` (a chunk of K corrections) each run as
one replay of a CUDA graph captured on first use (``utils/graphs.py``,
the counterpart of the JAX filter's ``jax.jit`` and ``lax.scan``);
on the CPU and inside ``disable_graphs()`` they run as the eager
sequence of launches, with no host synchronization either way.
Random draws come from a ``torch.Generator`` carried in the state. The
streams differ from jax.random's, so :func:`mcl_step` also takes the
resample offset ``u0``, the motion noise and the injection's mask
uniforms and poses from outside (the parity tests feed the JAX package's
own draws).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.config import MCLConfig, resolve_raycast_method
from monte_carlo_localization_tpu_torch.filter.init import initialize_global, initialize_pose
from monte_carlo_localization_tpu_torch.mapping.grid_map import GridMap
from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.models.sensor import SensorModel
from monte_carlo_localization_tpu_torch.ops.lut_query import (
    LUTQuery,
    required_row_stride,
    suggest_theta_bins,
)
from monte_carlo_localization_tpu_torch.ops.raycast import cast_rays, lut_expected_px
from monte_carlo_localization_tpu_torch.ops.resample import resample_indices
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device, upload
from monte_carlo_localization_tpu_torch.utils.graphs import Programs, shape_of
from monte_carlo_localization_tpu_torch.utils.timing import TRACER, TimingStats, call_ms

_STEP = TRACER.name("filter.step")
_STEP_MANY = TRACER.name("filter.step_many")


@dataclass(frozen=True)
class MCLState:
    """Filter state carried between steps. ``generator`` is advanced in
    place by every draw, so a state's successor shares it."""

    particles: torch.Tensor  # (N, 3) [x, y, theta]
    log_weights: torch.Tensor  # (N,) unnormalized logits
    generator: torch.Generator
    # log mean measurement likelihood of the latest correction, taken
    # before the max-shift (Augmented MCL's w_avg); 0 before the first
    log_quality: torch.Tensor | None = field(default=None)

    def __post_init__(self):
        if self.log_quality is None:
            object.__setattr__(
                self, "log_quality",
                torch.zeros((), dtype=torch.float32, device=self.particles.device),
            )

    @property
    def num_particles(self) -> int:
        return self.particles.shape[0]

    @classmethod
    def from_numpy(
        cls, particles, log_weights, seed: int,
        device: torch.device | str = DEFAULT_DEVICE,
    ) -> "MCLState":
        """A state from host arrays (e.g. the JAX filter's particles and
        log weights) with a fresh generator seeded by ``seed``."""
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(
            particles=torch.tensor(np.asarray(particles, np.float32), device=device),
            log_weights=torch.tensor(np.asarray(log_weights, np.float32), device=device),
            generator=gen,
        )

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        """(particles (N, 3), log_weights (N,)) as float32 numpy arrays."""
        return self.particles.cpu().numpy(), self.log_weights.cpu().numpy()


def expected_pose(particles: torch.Tensor, log_weights: torch.Tensor) -> torch.Tensor:
    """Weighted mean x/y and circular-mean heading: (3,) for (N, 3)
    particles, (F, 3) for a fleet's (F, N, 3)."""
    w = torch.softmax(log_weights, dim=-1)
    x = torch.sum(w * particles[..., 0], dim=-1)
    y = torch.sum(w * particles[..., 1], dim=-1)
    s = torch.sum(w * torch.sin(particles[..., 2]), dim=-1)
    c = torch.sum(w * torch.cos(particles[..., 2]), dim=-1)
    return torch.stack([x, y, torch.atan2(s, c)], dim=-1)


def sensor_update_px(
    particles: torch.Tensor,
    obs_px: torch.Tensor,
    beam_angles: torch.Tensor,
    grid_map: GridMap,
    sensor: SensorModel,
    raycast_method: str = "sphere",
    sphere_march_iters: int = 48,
    sensor_mode: str = "analytic",
) -> torch.Tensor:
    """Log likelihood per particle (JAX ``sensor_update``) of a scan
    binned by ``sensor.to_pixel_index``: particles (..., N, 3), obs_px
    (..., R) -> (..., N). Ray angle = particle heading + beam angle from
    the particle's position (particles live in the laser frame). Under
    ``lut`` with the analytic model the expected ranges come from the LUT
    in pixels (:func:`lut_expected_px`, no query matrix); otherwise every
    (particle, beam) pair is cast by ``raycast_method`` and scored in
    ``sensor_mode``. On a batched map the leading axis is the map."""
    obs = obs_px[..., None, :]
    if raycast_method == "lut" and sensor_mode == "analytic":
        logp = sensor.log_prob_analytic(obs, lut_expected_px(grid_map, particles, beam_angles))
        return sensor.inv_squash_factor * torch.sum(logp, dim=-1)
    *lead, n, _ = particles.shape
    r = beam_angles.shape[0]
    queries = torch.stack([
        particles[..., 0:1].expand(*lead, n, r),
        particles[..., 1:2].expand(*lead, n, r),
        particles[..., 2:3] + beam_angles,
    ], dim=-1).reshape(*lead, n * r, 3)
    ranges = cast_rays(grid_map, queries, method=raycast_method,
                       num_iters=sphere_march_iters).reshape(*lead, n, r)
    return sensor.log_likelihood_px(obs, ranges, mode=sensor_mode)


def sensor_update(particles, observed_m, beam_angles, grid_map, sensor, **kwargs) -> torch.Tensor:
    """:func:`sensor_update_px` of a scan in meters, the JAX
    ``sensor_update`` signature."""
    obs_px = sensor.to_pixel_index(observed_m).to(torch.float32)
    return sensor_update_px(particles, obs_px, beam_angles, grid_map, sensor, **kwargs)


def correct(
    particles: torch.Tensor,
    log_weights: torch.Tensor,
    generator: torch.Generator,
    action: torch.Tensor,
    obs_px: torch.Tensor,
    likelihood_fn,
    *,
    resample_method: str = "systematic",
    motion_dispersion: tuple[float, float, float] = (0.05, 0.025, 0.25),
    exact_dt_heuristic: bool = True,
    u0=None,
    noise: torch.Tensor | None = None,
    inject=None,
):
    """One MCL correction of (N, 3) particles, or of a fleet's (F, N, 3)
    with per-member actions (F, 3) and scans: the same launches serve
    every member. Returns (proposal, shifted log weights, log quality,
    pose).

    The reference's phase order: resample from the old weights, then
    motion, then the likelihood ``likelihood_fn(particles, obs_px)`` of
    the observed ranges in pixels; the pose comes from the new particles
    and weights. ``u0`` (systematic resampling offset, one per member)
    and ``noise`` (N(0, 1) motion noise shaped like the particles)
    replace the generator's draws when given. ``inject`` (proposal ->
    proposal) runs between motion and the likelihood.

    ``TRACER.mark()`` marks the phases' boundaries: event nodes in the
    first correction a graph captures, a flag check anywhere else.
    """
    TRACER.mark()
    idx = resample_indices(
        log_weights, method=resample_method, generator=generator, u0=u0
    )
    TRACER.mark()
    # the resampled rows' gather is motion's: one launch with it on a card
    proposal = motion_model(
        particles,
        action,
        dispersion_x=motion_dispersion[0],
        dispersion_y=motion_dispersion[1],
        dispersion_theta=motion_dispersion[2],
        exact_dt_heuristic=exact_dt_heuristic,
        generator=generator,
        noise=noise,
        indices=idx,
    )
    if inject is not None:
        proposal = inject(proposal)
    TRACER.mark()
    log_w = likelihood_fn(proposal, obs_px)
    TRACER.mark()
    # log(mean_i w_i) before the shift: linear space underflows at 1080 beams
    log_quality = torch.logsumexp(log_w, dim=-1) - math.log(log_w.shape[-1])
    log_w = log_w - torch.amax(log_w, dim=-1, keepdim=True)
    pose = expected_pose(proposal, log_w)
    TRACER.mark()
    return proposal, log_w, log_quality.to(torch.float32), pose


def inject_uniform(
    proposal: torch.Tensor,
    fraction: float | torch.Tensor,
    grid_map: GridMap,
    generator: torch.Generator,
    mask_u: torch.Tensor | None = None,
    injected: torch.Tensor | None = None,
) -> torch.Tensor:
    """Augmented-MCL injection (Probabilistic Robotics §8.3; JAX
    ``filter/core.py:173-179``): each of the N particles becomes its row
    of ``injected`` (N, 3), uniform free-space poses from
    :func:`initialize_global`, where its mask uniform ``mask_u`` (N,) is
    below ``fraction``. Both are drawn from ``generator`` (poses first)
    unless given. The fraction is float32, as the JAX step's traced
    scalar is: a number is rounded to it on the host; a 0-d float32
    tensor on the particles' device (a graph's input buffer, which the
    host writes before each replay) is compared as it is."""
    n = proposal.shape[0]
    if injected is None:
        injected, _ = initialize_global(generator, grid_map, n, dtype=proposal.dtype)
    if mask_u is None:
        mask_u = torch.rand(n, generator=generator, device=proposal.device)
    if injected.shape != proposal.shape or mask_u.shape != (n,):
        raise ValueError(
            f"injected {tuple(injected.shape)} / mask_u {tuple(mask_u.shape)} do not "
            f"fit {tuple(proposal.shape)} particles"
        )
    if not isinstance(fraction, torch.Tensor):
        fraction = float(np.float32(fraction))
    replace = mask_u < fraction
    return torch.where(replace[:, None], injected, proposal)


def mcl_step(
    state: MCLState,
    action: torch.Tensor,
    obs_px: torch.Tensor,
    likelihood_fn,
    *,
    inject_fraction: float | torch.Tensor | None = None,
    grid_map: GridMap | None = None,
    mask_u: torch.Tensor | None = None,
    injected: torch.Tensor | None = None,
    **kwargs,
) -> tuple[MCLState, torch.Tensor]:
    """One MCL correction (:func:`correct`) of a single filter. Returns
    (new_state, inferred_pose). With ``inject_fraction`` (not None) the
    proposal goes through :func:`inject_uniform` on ``grid_map``, with
    the draws ``mask_u`` and ``injected`` when given; None draws nothing
    more than the plain step."""
    inject = None
    if inject_fraction is not None:
        def inject(proposal):
            return inject_uniform(proposal, inject_fraction, grid_map, state.generator,
                                  mask_u, injected)
    proposal, log_w, log_quality, pose = correct(
        state.particles, state.log_weights, state.generator, action, obs_px,
        likelihood_fn, inject=inject, **kwargs,
    )
    new_state = MCLState(
        particles=proposal, log_weights=log_w, generator=state.generator,
        log_quality=log_quality,
    )
    return new_state, pose


# particles per block of the unique-window kernel when MCLConfig.pallas_block
# is 0: the JAX package's auto block at config #4's 100k particles
DEDUP_BLOCK = 160


def _resolve_dedup_slots(cfg: MCLConfig, num_members: int) -> int:
    """S of the unique-window kernel, as the JAX filter resolves it
    (``filter/core.py:329-336`` of the JAX package): an explicit S > 0
    turns it on for a single member; 0 and -1 (auto) are off, and so is
    a fleet of more than one member, which runs the fleet form instead."""
    if num_members > 1:
        return 0
    return max(cfg.pallas_dedup_slots, 0)


def lut_query_kwargs(grid_map: GridMap, cfg: MCLConfig, row_stride: int = 0) -> dict:
    """The map and beam-model arguments of :class:`LUTQuery` (and of
    ``MegaStep``) for a map with its kernel LUT attached, or whose LUT
    will have ``row_stride``. A batched map's origins go to each query
    call instead."""
    return dict(
        height=grid_map.height,
        width=grid_map.width,
        resolution=grid_map.resolution,
        origin_x=0.0 if grid_map.is_batched else grid_map.origin_x,
        origin_y=0.0 if grid_map.is_batched else grid_map.origin_y,
        max_range_px=grid_map.max_range_px,
        row_stride=row_stride or grid_map.row_stride,
        z_hit=cfg.z_hit,
        z_short=cfg.z_short,
        z_max=cfg.z_max,
        z_rand=cfg.z_rand,
        sigma_hit=cfg.sigma_hit,
        inv_squash=cfg.inv_squash_factor,
        lut_dtype=lut_dtype(grid_map.max_range_px),
        device=grid_map.device,
    )


def lut_likelihood_query(
    grid_map: GridMap, beam_angles: np.ndarray, cfg: MCLConfig, num_members: int = 1
) -> LUTQuery:
    """The fused likelihood's query for this beam set and ``num_members``
    fleet members, with the config's ``pallas_subbin``,
    ``pallas_dedup_slots`` and ``pallas_dedup_matmul`` (the last ignored
    without slots, as in the JAX filter). An unsupported beam geometry
    raises ``ValueError`` here, before any LUT is built."""
    dtype = lut_dtype(grid_map.max_range_px)
    beams = np.asarray(beam_angles, np.float32)
    t = suggest_theta_bins(beams)
    stride = required_row_stride(t, beams, itemsize=dtype.itemsize)
    slots = _resolve_dedup_slots(cfg, num_members)
    return LUTQuery(
        t, beams, **lut_query_kwargs(grid_map, cfg, stride),
        subbin=cfg.pallas_subbin,
        dedup_slots=slots,
        dedup_matmul=cfg.pallas_dedup_matmul and slots > 0,
        block=cfg.pallas_block or DEDUP_BLOCK,
        num_members=num_members,
        per_member_maps=grid_map.is_batched,
    )


def build_lut_likelihood(
    grid_map: GridMap, beam_angles: np.ndarray, cfg: MCLConfig, num_members: int = 1
) -> tuple[GridMap, LUTQuery]:
    """:func:`lut_likelihood_query` and the LUT it reads attached to the
    map (dense, or row-compacted past ``MCL_LUT_DENSE_MAX``; tight per-map
    blocks for a batched map). Returns (grid_map_with_lut, query)."""
    query = lut_likelihood_query(grid_map, beam_angles, cfg, num_members)
    grid_map = grid_map.with_kernel_lut(query.t_bins, query.row_stride, query.lut_dtype.itemsize)
    return grid_map, query


class ParticleFilter:
    """Single-filter facade: owns the map, config, sensor model and the
    likelihood. Everything lives on ``device`` (default: the map's).

    ``raycast_method`` ``auto`` (the default) and ``lut_pallas`` run the
    fused LUT kernel on a LUT matched to the beam set, attached by
    :meth:`set_beam_angles`; an auto-selected kernel on a beam set it
    cannot serve (a geometry ``ValueError``) falls back to ``lut`` with a
    warning, as the JAX filter does. ``lut`` attaches the dense
    ``lut_theta_bins`` LUT at construction; ``sphere`` and ``dda`` cast
    every ray (:func:`sensor_update_px`). With ``config.pallas_mega``
    (``lut_pallas`` on dense-LUT maps only) ``step_many`` runs each
    correction as one launch of the mega step (``filter/mega.py``);
    ``step`` stays the classic correction. ``pallas_subbin`` and
    ``pallas_dedup_slots`` select the fused likelihood's K3 and K4/K5
    forms on the classic correction (the mega step refuses them).

    On a card ``step`` (with or without ``inject_fraction``) and
    ``step_many`` replay CUDA graphs of the whole correction or chunk,
    captured once per shape and kept in ``programs``
    (``utils/graphs.py``); ``disable_graphs()`` runs them eagerly.
    """

    def __init__(
        self,
        grid_map: GridMap,
        config: MCLConfig | None = None,
        beam_angles: np.ndarray | None = None,
        device: torch.device | str | None = None,
    ):
        cfg = config or MCLConfig()
        self._auto_raycast = cfg.raycast_method == "auto"
        cfg = cfg.replace(raycast_method=resolve_raycast_method(cfg.raycast_method))
        if cfg.resample_method not in ("systematic", "multinomial"):
            raise ValueError(f"Unknown resample method: {cfg.resample_method!r}")
        if cfg.sensor_model_mode not in ("analytic", "table"):
            raise ValueError(f"Unknown sensor model mode: {cfg.sensor_model_mode!r}")
        if cfg.reinit_mode not in ("reinit", "inject"):
            raise ValueError(f"Unknown reinit mode: {cfg.reinit_mode!r}")
        self.config = cfg
        self.device = torch.device(device) if device is not None else grid_map.device
        self.grid_map = grid_map.to(self.device)
        if cfg.raycast_method == "lut":
            self.grid_map = self.grid_map.with_range_lut(cfg.lut_theta_bins)
        self.sensor = SensorModel.create(
            max_range_px=grid_map.max_range_px,
            resolution=grid_map.resolution,
            z_hit=cfg.z_hit,
            z_short=cfg.z_short,
            z_max=cfg.z_max,
            z_rand=cfg.z_rand,
            sigma_hit=cfg.sigma_hit,
            squash_factor=cfg.squash_factor,
            device=self.device,
        )
        self.beam_angles: torch.Tensor | None = None
        self.likelihood: LUTQuery | None = None  # the fused query under lut_pallas
        self.mega = None  # a MegaStepper once beams are set, with pallas_mega
        self.programs = Programs(self.device)
        if beam_angles is not None:
            self.set_beam_angles(beam_angles)

    def set_beam_angles(self, beam_angles: np.ndarray) -> None:
        """Set the (downsampled) beam angles. Under ``lut_pallas`` this
        attaches the LUT matched to this beam set and rebuilds the fused
        query (and the mega stepper)."""
        beams = np.asarray(beam_angles, np.float32)
        if self.config.raycast_method == "lut_pallas":
            self._attach_fused(beams)
        self.beam_angles = torch.as_tensor(beams, device=self.device)
        # graphs read the LUT, the query and the beams by address
        self.programs = Programs(self.device)

    def _attach_fused(self, beams: np.ndarray) -> None:
        cfg = self.config
        try:
            query = lut_likelihood_query(self.grid_map, beams, cfg)
        except ValueError as e:
            if not self._auto_raycast:
                raise
            # an auto-selected kernel on a beam geometry it cannot serve
            # (e.g. two beams in one theta bin): the XLA-style lut path
            warnings.warn(
                f"auto raycast: lut_pallas unsupported here ({e}); falling back to 'lut'",
                stacklevel=3,
            )
            self.config = cfg.replace(raycast_method="lut")
            self.grid_map = self.grid_map.with_range_lut(cfg.lut_theta_bins)
            self.likelihood = self.mega = None
            return
        self.grid_map = self.grid_map.with_kernel_lut(
            query.t_bins, query.row_stride, query.lut_dtype.itemsize)
        self.likelihood = query
        if cfg.pallas_mega:
            from monte_carlo_localization_tpu_torch.filter.mega import (
                MegaStepper,
                mega_supported,
            )

            if not mega_supported(self.grid_map, cfg):
                raise ValueError(
                    "pallas_mega needs a dense-LUT single map on the "
                    "analytic/systematic path (the compact LUT's row_map "
                    "gather cannot live in-kernel — see ops/pallas_mega.py)"
                )
            self.mega = MegaStepper(self.grid_map, beams, cfg, cfg.max_particles, self.sensor)

    def _generator(self, seed: int | None) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else int(seed))
        return gen

    def init_global(self, seed: int | None = None) -> MCLState:
        gen = self._generator(seed)
        particles, log_w = initialize_global(gen, self.grid_map, self.config.max_particles)
        return MCLState(particles=particles, log_weights=log_w, generator=gen)

    def init_pose(self, pose, seed: int | None = None) -> MCLState:
        gen = self._generator(seed)
        particles, log_w = initialize_pose(
            gen, pose, self.config.max_particles, device=self.device
        )
        return MCLState(particles=particles, log_weights=log_w, generator=gen)

    def _likelihood_fn(self, particles: torch.Tensor, obs_px: torch.Tensor) -> torch.Tensor:
        gm, cfg = self.grid_map, self.config
        if self.likelihood is not None:
            return self.likelihood(gm.range_lut, particles, obs_px, row_map=gm.lut_row_map)
        return sensor_update_px(
            particles, obs_px, self.beam_angles, gm, self.sensor,
            raycast_method=cfg.raycast_method, sphere_march_iters=cfg.sphere_march_iters,
            sensor_mode=cfg.sensor_model_mode,
        )

    def _step(self, state, action, obs_px, u0=None, noise=None, **inject):
        cfg = self.config
        return mcl_step(
            state, action, obs_px, self._likelihood_fn,
            resample_method=cfg.resample_method,
            motion_dispersion=(
                cfg.motion_dispersion_x,
                cfg.motion_dispersion_y,
                cfg.motion_dispersion_theta,
            ),
            exact_dt_heuristic=cfg.exact_dt_heuristic,
            u0=u0,
            noise=noise,
            grid_map=self.grid_map,
            **inject,
        )

    def _require_beams(self) -> None:
        if self.beam_angles is None:
            raise RuntimeError("beam_angles not set — call set_beam_angles() first")

    def _keep(self) -> tuple:
        """What a graph of this filter reads by address."""
        return (self.grid_map, self.sensor, self.beam_angles, self.likelihood)

    def step(
        self, state: MCLState, action, observed_m, inject_fraction: float | None = None,
        u0=None, noise=None, mask_u=None, injected=None,
    ) -> tuple[MCLState, torch.Tensor]:
        """One MCL correction, launched without waiting for the device
        (host inputs go up through pinned memory); on a card one replay of
        the step's graph. ``inject_fraction``: Augmented-MCL injection for
        this correction (None: the plain step, whose draws it leaves as
        they are); one graph of the injection step serves every fraction.
        Optional draws: ``u0`` (scalar), ``noise`` (N, 3), and with
        injection ``mask_u`` (N,) and ``injected`` (N, 3). Recorded as
        the ``TRACER`` span ``filter.step``."""
        token = TRACER.open(_STEP)
        try:
            return self._step_call(state, action, observed_m, inject_fraction, u0, noise,
                                   mask_u, injected)
        finally:
            TRACER.close(token)

    def _step_call(self, state, action, observed_m, inject_fraction, u0, noise, mask_u,
                   injected):
        self._require_beams()
        if inject_fraction is None and (mask_u is not None or injected is not None):
            raise ValueError("mask_u and injected need an inject_fraction")
        draws = {name: v for name, v in dict(u0=u0, noise=noise, mask_u=mask_u,
                                              injected=injected).items() if v is not None}
        inputs = dict(particles=state.particles, log_weights=state.log_weights,
                      action=action, observed_m=observed_m, **draws)
        if inject_fraction is not None:
            inputs["fraction"] = float(np.float32(inject_fraction))

        def program(b, gen):
            obs_px = self.sensor.to_pixel_index(b["observed_m"]).to(torch.float32)
            new, pose = self._step(
                MCLState(b["particles"], b["log_weights"], gen), b["action"], obs_px,
                inject_fraction=b.get("fraction"), **{name: b[name] for name in draws})
            return dict(particles=new.particles, log_weights=new.log_weights,
                        log_quality=new.log_quality, pose=pose)

        key = ("step", inject_fraction is not None, *sorted(draws))
        out = self.programs(key, program, inputs, state.generator, self._keep())
        return MCLState(particles=out["particles"], log_weights=out["log_weights"],
                        generator=state.generator, log_quality=out["log_quality"]), out["pose"]

    def step_many(
        self, state: MCLState, actions, observed_m, u0=None, noise=None
    ) -> tuple[MCLState, torch.Tensor]:
        """K sequential corrections with no host synchronization between
        them, on a card one replay of the K-correction graph (the JAX
        filter's ``lax.scan``): ``actions`` (K, 3), ``observed_m`` (K, R).
        Optional draws: ``u0`` (K,) and ``noise`` (K, N, 3). Returns
        (state, poses (K, 3)). With ``pallas_mega`` each correction is one
        mega-step launch. Recorded as the ``TRACER`` span
        ``filter.step_many``."""
        token = TRACER.open(_STEP_MANY)
        try:
            return self._step_many_call(state, actions, observed_m, u0, noise)
        finally:
            TRACER.close(token)

    def _step_many_call(self, state, actions, observed_m, u0, noise):
        self._require_beams()
        k = shape_of(actions)[0]
        if shape_of(observed_m)[0] != k:
            raise ValueError(f"{k} actions but {shape_of(observed_m)[0]} scans")
        if u0 is not None and shape_of(u0) != (k,):
            raise ValueError(f"u0 shape {shape_of(u0)} != ({k},)")
        if noise is not None and shape_of(noise) != (k, state.num_particles, 3):
            raise ValueError(
                f"noise shape {shape_of(noise)} != ({k}, {state.num_particles}, 3)"
            )
        if self.mega is not None:
            return self.mega.step_many(state, actions, observed_m, u0=u0, noise=noise)
        draws = {name: v for name, v in dict(u0=u0, noise=noise).items() if v is not None}
        inputs = dict(particles=state.particles, log_weights=state.log_weights,
                      actions=actions, observed_m=observed_m, **draws)

        def program(b, gen):
            obs_px = self.sensor.to_pixel_index(b["observed_m"]).to(torch.float32)
            st, poses = MCLState(b["particles"], b["log_weights"], gen), []
            for i in range(k):
                st, pose = self._step(st, b["actions"][i], obs_px[i],
                                      **{name: b[name][i] for name in draws})
                poses.append(pose)
            return dict(particles=st.particles, log_weights=st.log_weights,
                        log_quality=st.log_quality, poses=torch.stack(poses))

        out = self.programs(("step_many", *sorted(draws)), program, inputs, state.generator,
                            self._keep())
        return MCLState(particles=out["particles"], log_weights=out["log_weights"],
                        generator=state.generator, log_quality=out["log_quality"]), out["poses"]

    def log_quality(self, state: MCLState) -> float:
        """log mean (squashed) measurement likelihood of the latest
        correction, before the max-shift: Augmented MCL's w_avg."""
        return float(state.log_quality)

    def profile_phases(self, state: MCLState, action, observed_m,
                       iters: int = 20) -> TimingStats:
        """Per-phase times of one correction, the analogue of the
        reference's TimingStats printout (reference src/utils.cpp:105-125)
        and of the JAX filter's ``profile_phases``: resample (with the row
        gather), motion, the production likelihood (the LUT kernel on a
        card) and the whole step, each run ``iters`` times on the same
        inputs after a warm-up, timed between CUDA events on a card (the
        host clock on the CPU). Each field holds the total ms over
        ``iters`` runs; ``measurement_count`` is ``iters``. ``state`` is
        not advanced (its generator is). Under ``sphere``, ``dda`` and
        ``lut`` the likelihood phase is :func:`sensor_update_px`."""
        self._require_beams()
        cfg = self.config
        action = upload(action, self.device)
        obs_px = self.sensor.to_pixel_index(upload(observed_m, self.device)).to(torch.float32)
        gen = state.generator
        dispersion = (cfg.motion_dispersion_x, cfg.motion_dispersion_y,
                      cfg.motion_dispersion_theta)

        def resample():
            idx = resample_indices(state.log_weights, method=cfg.resample_method,
                                   generator=gen)
            return state.particles[idx]

        proposal = resample()

        def motion():
            return motion_model(
                proposal, action, dispersion_x=dispersion[0], dispersion_y=dispersion[1],
                dispersion_theta=dispersion[2], exact_dt_heuristic=cfg.exact_dt_heuristic,
                generator=gen,
            )

        moved = motion()
        stats = TimingStats(measurement_count=iters)
        stats.resampling_time = call_ms(resample, iters, self.device) * iters
        stats.motion_model_time = call_ms(motion, iters, self.device) * iters
        stats.sensor_model_time = call_ms(
            lambda: self._likelihood_fn(moved, obs_px), iters, self.device) * iters
        stats.total_mcl_time = call_ms(
            lambda: self._step(state, action, obs_px), iters, self.device) * iters
        return stats
