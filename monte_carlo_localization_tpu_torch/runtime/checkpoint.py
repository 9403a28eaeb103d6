"""Filter state checkpoint / resume, single filter and fleet: the JAX
package's ``runtime/checkpoint.py`` with the same npz keys and versions,
so a file written by either package loads in the other.

A checkpoint holds particles, log weights, the random state, the
iteration counter and the host tracker's anchors. The JAX package keeps
its random state as ``key_data`` (uint32 (2,) per key, as
``jax.random.key_data`` gives it); the port's is a ``torch.Generator``.
So the port writes both: ``key_data`` holds the generator's initial seed
as a JAX key would (high word, low word), and ``torch_generator_state``
with ``torch_generator_device`` holds the generator's exact state, which
the JAX package ignores. A port file resumes bit for bit on a device of
the same type; a JAX file, or a port file read on another device type,
seeds the generator from ``key_data``. The random streams of the two
packages cannot match, so a resumed filter continues with other draws
than its writer would have taken.

``load_state(path, place=spf.place_state)`` resumes a sharded filter
(``parallel/sharded.py``): the whole state is read and ``place`` keeps
this process's rows on its device, so a checkpoint written at one shard
count resumes at another (write one with ``spf.gather_state``).
``load_fleet_state(path, fleet=ff)`` keeps a meshed fleet's rows the
same way (``FleetFilter.place_state``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from monte_carlo_localization_tpu_torch.filter.core import MCLState
from monte_carlo_localization_tpu_torch.parallel.fleet import FleetState
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_VERSION = 1
_FLEET_VERSION = 1


def _key_data(seed: int) -> np.ndarray:
    """A 64-bit seed as the uint32 (hi, lo) pair of a JAX threefry key."""
    seed &= (1 << 64) - 1
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _seed_of(key_data: np.ndarray) -> int:
    hi, lo = (int(v) for v in np.asarray(key_data, np.uint32).reshape(-1)[:2])
    return (hi << 32) | lo


def _generator_arrays(gen: torch.Generator) -> dict:
    return dict(
        torch_generator_state=gen.get_state().numpy(),
        torch_generator_device=np.asarray(gen.device.type),
    )


def _generator(z, key_data: np.ndarray, device: torch.device) -> torch.Generator:
    """The writer's generator state where it fits ``device``, else a
    generator seeded from ``key_data``."""
    gen = torch.Generator(device=device)
    if (
        "torch_generator_state" in z
        and str(z["torch_generator_device"]) == device.type
    ):
        gen.set_state(torch.from_numpy(z["torch_generator_state"].copy()))
    else:
        gen.manual_seed(_seed_of(key_data))
    return gen


def _write(path: Path, arrays: dict) -> None:
    tmp = path.with_name(path.name + ".tmp")
    np.savez_compressed(tmp, **arrays)
    tmp_actual = tmp if tmp.exists() else tmp.with_suffix(tmp.suffix + ".npz")
    tmp_actual.replace(path)


def _extra(z) -> dict:
    return {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}


def save_state(
    path: str | Path,
    state: MCLState,
    *,
    iters: int = 0,
    inferred_pose: np.ndarray | None = None,
    tracker=None,
    extra: dict | None = None,
) -> None:
    """Write a filter checkpoint (atomic replace)."""
    path = Path(path)
    arrays = dict(
        version=np.asarray(_VERSION),
        particles=state.particles.cpu().numpy(),
        log_weights=state.log_weights.cpu().numpy(),
        key_data=_key_data(state.generator.initial_seed()),
        log_quality=state.log_quality.cpu().numpy(),
        iters=np.asarray(iters),
        **_generator_arrays(state.generator),
    )
    if inferred_pose is not None:
        arrays["inferred_pose"] = np.asarray(inferred_pose)
    if tracker is not None:
        snap = tracker.snapshot()
        arrays["tracker_active"] = np.asarray(tracker.active)
        arrays["tracker_reference_pose"] = np.asarray(tracker._reference_pose)
        arrays["tracker_reference_odom"] = np.asarray(tracker._reference_odom)
        arrays["tracker_velocity"] = np.asarray(snap.velocity)
        arrays["tracker_angular_velocity"] = np.asarray(snap.angular_velocity)
        arrays["tracker_from_seed"] = np.asarray(tracker.pose_initialized_from_seed)
        arrays["tracker_ref_odom_pending"] = np.asarray(tracker._reference_odom_pending)
        if snap.pose is not None:
            arrays["tracker_pose"] = snap.pose
        if snap.last_odom_pose is not None:
            arrays["tracker_last_odom"] = snap.last_odom_pose
        if snap.last_stamp is not None:
            arrays["tracker_last_stamp"] = np.asarray(snap.last_stamp)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = np.asarray(v)
    _write(path, arrays)


def load_state(path: str | Path, tracker=None, place=None,
               device: torch.device | str = DEFAULT_DEVICE):
    """Read a checkpoint -> (MCLState on ``device``, meta dict). Restores
    the tracker anchors in place when one is passed. ``place`` (a callable
    ``MCLState -> MCLState``, e.g. ``ShardedParticleFilter.place_state``)
    re-places the restored state."""
    device = resolve_device(device)
    with np.load(Path(path), allow_pickle=False) as z:
        if int(z["version"]) != _VERSION:
            raise ValueError(f"Unsupported checkpoint version {int(z['version'])}")
        state = MCLState(
            particles=torch.tensor(z["particles"], dtype=torch.float32, device=device),
            log_weights=torch.tensor(z["log_weights"], dtype=torch.float32, device=device),
            generator=_generator(z, z["key_data"], device),
            log_quality=torch.tensor(
                z["log_quality"] if "log_quality" in z else 0.0,
                dtype=torch.float32, device=device,
            ),
        )
        meta = {"iters": int(z["iters"])}
        if "inferred_pose" in z:
            meta["inferred_pose"] = z["inferred_pose"]
        if tracker is not None and "tracker_active" in z:
            with tracker._lock:
                tracker.active = bool(z["tracker_active"])
                tracker._reference_pose = z["tracker_reference_pose"].copy()
                tracker._reference_odom = z["tracker_reference_odom"].copy()
                if "tracker_velocity" in z:
                    tracker.velocity = float(z["tracker_velocity"])
                    tracker.angular_velocity = float(z["tracker_angular_velocity"])
                if "tracker_from_seed" in z:
                    tracker.pose_initialized_from_seed = bool(z["tracker_from_seed"])
                if "tracker_ref_odom_pending" in z:
                    tracker._reference_odom_pending = bool(z["tracker_ref_odom_pending"])
                elif tracker.active and "tracker_last_odom" not in z:
                    # older checkpoint anchored before any odometry: rebase
                    # the delta at the first post-resume message
                    tracker._reference_odom_pending = True
                if "tracker_pose" in z:
                    tracker._odom_pose = z["tracker_pose"].copy()
                if "tracker_last_odom" in z:
                    tracker._last_odom_pose = z["tracker_last_odom"].copy()
                if "tracker_last_stamp" in z:
                    tracker._last_stamp = float(z["tracker_last_stamp"])
        extra = _extra(z)
    if extra:
        meta["extra"] = extra
    if place is not None:
        state = place(state)
    return state, meta


def save_fleet_state(
    path: str | Path,
    state: FleetState,
    *,
    iters: int = 0,
    poses: np.ndarray | None = None,
    extra: dict | None = None,
) -> None:
    """Write a FleetState checkpoint (atomic replace). ``keys_data`` holds
    one JAX key per member, member f's from the generator's initial seed
    plus f; ``poses`` optionally records the latest (F, 3) pose table."""
    path = Path(path)
    seed = state.generator.initial_seed()
    arrays = dict(
        fleet_version=np.asarray(_FLEET_VERSION),
        particles=state.particles.cpu().numpy(),
        log_weights=state.log_weights.cpu().numpy(),
        keys_data=np.stack([_key_data(seed + f) for f in range(state.fleet_size)]),
        iters=np.asarray(iters),
        **_generator_arrays(state.generator),
    )
    if poses is not None:
        arrays["poses"] = np.asarray(poses)
    if extra:
        for k, v in extra.items():
            arrays[f"extra_{k}"] = np.asarray(v)
    _write(path, arrays)


def load_fleet_state(path: str | Path, fleet=None,
                     device: torch.device | str = DEFAULT_DEVICE):
    """Read a fleet checkpoint -> (FleetState, meta dict), on ``fleet``'s
    device when a ``FleetFilter`` is given (its member count must match;
    a meshed fleet keeps its rows, ``FleetFilter.place_state``), else on
    ``device``. A file without the port's generator state seeds the
    fleet's one generator from member 0's key."""
    with np.load(Path(path), allow_pickle=False) as z:
        if "fleet_version" not in z:
            raise ValueError(
                f"{path} is not a fleet checkpoint (single-filter checkpoints "
                "load with load_state)"
            )
        if int(z["fleet_version"]) != _FLEET_VERSION:
            raise ValueError(
                f"Unsupported fleet checkpoint version {int(z['fleet_version'])}"
            )
        if fleet is not None:
            device = fleet.device
            if z["particles"].shape[0] != fleet.fleet_size:
                raise ValueError(
                    f"checkpoint holds {z['particles'].shape[0]} members, fleet has "
                    f"{fleet.fleet_size}"
                )
        device = resolve_device(device)
        state = FleetState(
            particles=torch.tensor(z["particles"], dtype=torch.float32, device=device),
            log_weights=torch.tensor(z["log_weights"], dtype=torch.float32, device=device),
            generator=_generator(z, z["keys_data"][0], device),
        )
        meta = {"iters": int(z["iters"])}
        if "poses" in z:
            meta["poses"] = z["poses"]
        extra = _extra(z)
    if extra:
        meta["extra"] = extra
    if fleet is not None and fleet.mesh is not None:
        state = fleet.place_state(state)
    return state, meta
