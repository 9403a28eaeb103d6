"""The port's fleet (``parallel/fleet.py``) against the JAX package's.

Maps are made from one occupancy array in both packages. Gates:
``stack_maps`` fields equal; tight member LUT buffers and bases bit-equal
(dense, and compact forced by lowering ``MCL_LUT_DENSE_MAX``); the fleet
plain query within 2e-3 of JAX's fleet ``query`` in interpret mode;
three chained ``FleetFilter`` corrections on JAX's own per-member draws
with poses within 1e-3 and at least 99% of particle rows within 1e-4
(the f32 weight CDFs are summed in different orders, so a knife-edge
resample slot may flip), as ``tests/test_torch_filter.py`` holds the
single filter.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from monte_carlo_localization_tpu.config import MCLConfig as JMCLConfig
from monte_carlo_localization_tpu.mapping import map_from_occupancy as j_map_from_occupancy
from monte_carlo_localization_tpu.ops import pallas_lut as jlut
from monte_carlo_localization_tpu.parallel import FleetFilter as JFleetFilter
from monte_carlo_localization_tpu.parallel import stack_maps as j_stack_maps
from monte_carlo_localization_tpu_torch import GridMap, MCLConfig, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping import map_from_occupancy
from monte_carlo_localization_tpu_torch.ops import lut_query as tlut
from monte_carlo_localization_tpu_torch.ops.resample import (
    prefix_sum_doubling,
    systematic_invert_cdf_window,
    systematic_resample_indices,
)
from monte_carlo_localization_tpu_torch.models.motion import motion_model
from monte_carlo_localization_tpu_torch.filter.core import expected_pose
from monte_carlo_localization_tpu_torch.parallel import FleetFilter, FleetState, stack_maps

RES = 0.05
BEAMS = np.linspace(-2.35, 2.35, 60).astype(np.float32)
BEAM_MODEL = dict(z_hit=0.8, z_short=0.01, z_max=0.07, z_rand=0.12, sigma_hit=8.0,
                  inv_squash=1 / 2.2)


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


def _occupancy(h, w, seed, obstacles=4):
    rng = np.random.default_rng(seed)
    occ = np.zeros((h, w), np.int8)
    occ[:3, :] = occ[-3:, :] = occ[:, :3] = occ[:, -3:] = 100
    for _ in range(obstacles):
        oh, ow = rng.integers(3, 9, 2)
        r, c = rng.integers(8, h - 8 - oh), rng.integers(8, w - 8 - ow)
        occ[r:r + oh, c:c + ow] = 100
    return occ


# (height, width, origin, seed): three maps of different shapes and origins
MAP_SPECS = [(64, 80, (-1.0, 0.5, 0.0), 1), (48, 96, (0.3, -0.7, 0.2), 2),
             (72, 56, (2.0, 1.0, 0.0), 3)]


def _map_pair(spec, max_range_meters=6.0):
    h, w, origin, seed = spec
    occ = _occupancy(h, w, seed)
    kw = dict(resolution=RES, origin=origin, max_range_meters=max_range_meters)
    return j_map_from_occupancy(occ, **kw), map_from_occupancy(occ, **kw, device="cpu")


def _stacked(specs, max_range_meters=6.0):
    pairs = [_map_pair(s, max_range_meters) for s in specs]
    return j_stack_maps([j for j, _ in pairs]), stack_maps([t for _, t in pairs]), pairs


def _carry(jm) -> GridMap:
    """A JAX batched map with its LUT, carried across."""
    def arr(x):
        return None if x is None else np.asarray(x)

    return GridMap.from_numpy(
        occupancy=arr(jm.occupancy), free_cells=arr(jm.free_cells), num_free=arr(jm.num_free),
        clearance=arr(jm.clearance), origin_x=arr(jm.origin_x), origin_y=arr(jm.origin_y),
        origin_yaw=arr(jm.origin_yaw), resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters, name=jm.name, range_lut=arr(jm.range_lut),
        lut_row_map=arr(jm.lut_row_map), lut_theta_bins=jm.lut_theta_bins,
        lut_row_stride=jm.lut_row_stride, member_dims=arr(jm.member_dims),
        lut_member_base=arr(jm.lut_member_base), lut_row_map_base=arr(jm.lut_row_map_base),
        device="cpu",
    )


def test_stack_maps_matches_jax():
    jm, tm, _ = _stacked(MAP_SPECS)
    assert tm.is_batched and tm.num_maps == 3
    for name in ("occupancy", "occupied", "permissible", "clearance", "free_cells",
                 "num_free", "origin_x", "origin_y", "origin_yaw", "member_dims"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
                                      err_msg=name)
    assert (tm.resolution, tm.max_range_px, tm.max_range_meters, tm.name) == (
        jm.resolution, jm.max_range_px, jm.max_range_meters, jm.name)
    assert tm.origin_x.dtype == torch.float32 and tm.num_free.dtype == torch.int32


@pytest.mark.parametrize("max_range_meters", [6.0, 15.0], ids=["u8", "u16"])
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_member_luts_bit_equal_to_jax(max_range_meters, compact, monkeypatch):
    jm, tm, _ = _stacked(MAP_SPECS, max_range_meters)
    itemsize = 1 if tm.max_range_px <= 254 else 2
    t = jlut.suggest_theta_bins(BEAMS)
    stride = jlut.required_row_stride(t, BEAMS, itemsize=itemsize)
    eps = jlut.entries_per_subrow(itemsize)
    if compact:
        monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")  # the filters' rule picks compact
        jl = jm.with_member_compact_luts(t, stride, eps)
    else:
        jl = jm.with_member_luts(t, stride, eps)
    tl = tm.with_kernel_lut(t, stride, itemsize)
    assert (tl.lut_row_map is not None) == compact
    np.testing.assert_array_equal(tl.range_lut.numpy(), np.asarray(jl.range_lut).reshape(-1))
    np.testing.assert_array_equal(tl.lut_member_base.numpy(), np.asarray(jl.lut_member_base))
    if compact:
        np.testing.assert_array_equal(tl.lut_row_map.numpy(), np.asarray(jl.lut_row_map))
        np.testing.assert_array_equal(tl.lut_row_map_base.numpy(),
                                      np.asarray(jl.lut_row_map_base))
    else:
        assert tl.lut_row_map_base is None and jl.lut_row_map_base is None
    assert tl.row_stride == (jl.lut_row_stride or jl.lut_theta_bins)
    # the carried JAX map is reused as it is, not rebuilt
    carried = _carry(jl)
    assert carried.with_kernel_lut(t, stride, itemsize).range_lut is carried.range_lut


# fleet query cases: (maps (h, w), members F, npm, map_of, member_base, compact,
# max_range_px, subbin). npm 20 and 12 are not multiples of 8; JAX's block is 4.
QUERY_CASES = {
    "3_members_2_maps": ([(40, 48), (24, 64)], 3, 20, [0, 1, 0], 0, False, 120, False),
    "shared_map_of": ([(40, 48), (24, 64)], 4, 12, [1, 1, 0, 1], 0, False, 120, False),
    "identity_maps": ([(40, 48), (24, 64), (32, 32)], 3, 12, None, 0, False, 120, False),
    "compact_row_map_bases": ([(40, 48), (24, 64)], 3, 20, [1, 0, 1], 0, True, 120, False),
    "u16": ([(40, 48), (24, 64)], 3, 20, [0, 1, 1], 0, False, 400, False),
    "subbin": ([(40, 48), (24, 64)], 3, 20, [0, 1, 0], 0, True, 120, True),
    "member_base_2": ([(40, 48), (24, 64)], 2, 16, [0, 0, 1, 0, 1], 2, False, 120, False),
}


def _fleet_case(maps, f, npm, map_of, member_base, compact, max_range_px, seed):
    """Random tight LUT blocks, per-map origins, particles of which some lie
    off their member's map, and one scan per member."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if max_range_px <= 254 else np.uint16
    itemsize = np.dtype(dtype).itemsize
    t = jlut.suggest_theta_bins(BEAMS)
    stride = jlut.required_row_stride(t, BEAMS, itemsize=itemsize)
    eps = jlut.entries_per_subrow(itemsize)
    m = len(maps)
    dims = np.array(maps, np.int32)
    ox = rng.uniform(-2, 2, m).astype(np.float32)
    oy = rng.uniform(-2, 2, m).astype(np.float32)
    blocks, bases, rmaps, rbases, at, rat = [], [], [], [], 0, 0
    for h, w in maps:
        rows = h * w // 3 + 1 if compact else h * w
        blocks.append(rng.integers(0, max_range_px + 1, (rows, stride)).astype(dtype))
        bases.append(at)
        at += rows * (stride // eps)
        if compact:
            rmaps.append(rng.integers(0, rows, h * w).astype(np.int32))
            rbases.append(rat)
            rat += h * w
    lut = np.concatenate([b.reshape(-1) for b in blocks])
    members = np.arange(f) + member_base
    mi = np.asarray(map_of)[members] if map_of is not None else members
    parts = np.zeros((f, npm, 3), np.float32)
    for k in range(f):
        h, w = maps[mi[k]]
        parts[k, :, 0] = rng.uniform(ox[mi[k]] - 0.2, ox[mi[k]] + w * RES + 0.2, npm)
        parts[k, :, 1] = rng.uniform(oy[mi[k]] - 0.2, oy[mi[k]] + h * RES + 0.2, npm)
        parts[k, :, 2] = rng.uniform(-2 * math.pi, 2 * math.pi, npm)
    obs = rng.uniform(0, max_range_px * 1.1, (f, len(BEAMS))).astype(np.float32)
    args = dict(
        origins=(ox, oy), map_of=None if map_of is None else np.asarray(map_of, np.int32),
        dims=dims, lut_bases=np.asarray(bases, np.int32),
        row_map_bases=np.asarray(rbases, np.int32) if compact else None,
        member_base=member_base,
    )
    row_map = np.concatenate(rmaps) if compact else None
    geometry = dict(t=t, stride=stride, dtype=dtype, height=max(h for h, _ in maps),
                    width=max(w for _, w in maps))
    return lut, parts.reshape(-1, 3), obs, row_map, args, geometry


def _fleet_queries(geometry, n, f, max_range_px, subbin, block=4):
    kw = dict(height=geometry["height"], width=geometry["width"], resolution=RES,
              origin_x=0.0, origin_y=0.0, max_range_px=max_range_px,
              row_stride=geometry["stride"], lut_dtype=geometry["dtype"], subbin=subbin,
              num_members=f, per_member_maps=True, **BEAM_MODEL)
    jq, _ = jlut.build_lut_query_fn(geometry["t"], BEAMS, n, block=block, interpret=True, **kw)
    tq = tlut.LUTQuery(geometry["t"], BEAMS, **kw, device="cpu")
    return jq, tq


@pytest.mark.parametrize("case", list(QUERY_CASES), ids=list(QUERY_CASES))
def test_fleet_plain_query_matches_jax(case):
    maps, f, npm, map_of, member_base, compact, max_range_px, subbin = QUERY_CASES[case]
    lut, parts, obs, row_map, args, geo = _fleet_case(
        maps, f, npm, map_of, member_base, compact, max_range_px, seed=len(case))
    jq, tq = _fleet_queries(geo, f * npm, f, max_range_px, subbin)
    want = np.asarray(jq(
        jnp.asarray(lut), jnp.asarray(parts), jnp.asarray(obs),
        row_map=None if row_map is None else jnp.asarray(row_map),
        member_base=member_base,
        origins=tuple(jnp.asarray(o) for o in args["origins"]),
        map_of=None if args["map_of"] is None else jnp.asarray(args["map_of"]),
        dims=jnp.asarray(args["dims"]), lut_bases=jnp.asarray(args["lut_bases"]),
        row_map_bases=None if args["row_map_bases"] is None else jnp.asarray(args["row_map_bases"]),
    ))
    got = tq(torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs),
             row_map=None if row_map is None else torch.from_numpy(row_map),
             **{k: v for k, v in args.items()}).numpy()
    assert tq.launch_count == tq.fleet_launch_count == 0  # CPU: the plain version
    off = want == -1e4
    assert 0 < off.sum() < len(want), "the case needs particles on and off the maps"
    np.testing.assert_array_equal(got == -1e4, off)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_one_map_fleet_query_matches_jax():
    """num_members > 1 on one map: each member reads its own scan."""
    rng = np.random.default_rng(5)
    h, w, f, npm = 40, 48, 3, 12
    t = jlut.suggest_theta_bins(BEAMS)
    stride = jlut.required_row_stride(t, BEAMS, itemsize=1)
    kw = dict(height=h, width=w, resolution=RES, origin_x=-0.5, origin_y=0.25,
              max_range_px=120, row_stride=stride, num_members=f, **BEAM_MODEL)
    jq, _ = jlut.build_lut_query_fn(t, BEAMS, f * npm, block=4, interpret=True, **kw)
    tq = tlut.LUTQuery(t, BEAMS, **kw, device="cpu")
    lut = rng.integers(0, 121, h * w * stride).astype(np.uint8)
    parts = np.stack([rng.uniform(-0.7, w * RES - 0.3, f * npm),
                      rng.uniform(0.05, h * RES + 0.45, f * npm),
                      rng.uniform(-4, 4, f * npm)], 1).astype(np.float32)
    obs = rng.uniform(0, 130, (f, 60)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(lut), jnp.asarray(parts), jnp.asarray(obs)))
    got = tq(torch.from_numpy(lut), torch.from_numpy(parts), torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    # member scans matter: one scan for all members gives other weights
    same = tq(torch.from_numpy(lut), torch.from_numpy(parts),
              torch.from_numpy(np.repeat(obs[:1], f, 0))).numpy()
    assert np.abs(same[npm:] - got[npm:]).max() > 1e-2


def test_batched_resample_motion_pose_equal_per_member():
    """The fleet's batched phases give each member what it gets alone: the
    resampler and the prefix sum bit for bit; motion and the pose within
    1e-6, since the CPU's vectorized sin/cos and its scalar tail loop
    round the last ulp differently at other offsets."""
    rng = np.random.default_rng(6)
    f, n = 4, 300
    logw = torch.from_numpy(rng.normal(0, 3, (f, n)).astype(np.float32))
    u0 = torch.from_numpy(rng.uniform(size=f).astype(np.float32))
    parts = torch.from_numpy(rng.normal(0, 2, (f, n, 3)).astype(np.float32))
    actions = torch.from_numpy(rng.normal(0, 0.05, (f, 3)).astype(np.float32))
    noise = torch.from_numpy(rng.normal(size=(f, n, 3)).astype(np.float32))
    idx = systematic_resample_indices(logw, u0=u0)
    moved = motion_model(parts, actions, noise=noise)
    poses = expected_pose(parts, logw)
    for k in range(f):
        torch.testing.assert_close(idx[k], systematic_resample_indices(logw[k], u0=u0[k]),
                                   rtol=0, atol=0)
        torch.testing.assert_close(moved[k], motion_model(parts[k], actions[k], noise=noise[k]),
                                   rtol=0, atol=1e-6)
        torch.testing.assert_close(poses[k], expected_pose(parts[k], logw[k]), rtol=0, atol=1e-6)
        torch.testing.assert_close(prefix_sum_doubling(logw)[k], prefix_sum_doubling(logw[k]),
                                   rtol=0, atol=0)
    # windows past slot 0 scatter out-of-window sources to the spare slot
    cdf = torch.softmax(logw, -1).cumsum(-1)
    win = systematic_invert_cdf_window(cdf, u0, n, 100, 50)
    for k in range(f):
        torch.testing.assert_close(win[k], systematic_invert_cdf_window(cdf[k], u0[k], n, 100, 50),
                                   rtol=0, atol=0)


def _jax_member_draws(keys, n):
    """JAX FleetFilter.propose's draws for every member: key, kr, km =
    split(key, 3); u0 from kr, the (N, 3) motion noise from km."""
    u0, noise = [], []
    for key in keys:
        _, kr, km = jax.random.split(key, 3)
        u0.append(float(jax.random.uniform(kr, ())))
        noise.append(np.array(jax.random.normal(km, (n, 3), jnp.float32)))
    return np.float32(u0), np.stack(noise)


def _scan(jmap, pose):
    from monte_carlo_localization_tpu.ops.raycast import cast_rays_dda

    q = np.stack([np.full(60, pose[0]), np.full(60, pose[1]), pose[2] + BEAMS], 1)
    return np.asarray(cast_rays_dda(jmap, jnp.asarray(q.astype(np.float32))))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
def test_fleet_filter_matches_jax_on_its_draws(compact, monkeypatch):
    if compact:
        monkeypatch.setenv("MCL_LUT_DENSE_MAX", "1")
    jm, _, pairs = _stacked(MAP_SPECS[:2])
    f, n, steps = 4, 128, 3
    asg = np.array([0, 1, 1, 0], np.int32)
    cfg = dict(max_particles=n, raycast_method="lut_pallas")
    jff = JFleetFilter(jm, fleet_size=f, config=JMCLConfig(**cfg), beam_angles=BEAMS,
                       map_assignment=asg)
    ff = FleetFilter(_carry(jff.map), f, MCLConfig(**cfg), beam_angles=BEAMS,
                     map_assignment=asg)
    assert (ff.map.lut_row_map is not None) == compact
    assert ff.map.range_lut.data_ptr() != 0 and ff.likelihood.per_member_maps
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.5, -0.2, 0.1], [1.2, 0.4, -0.5], [1.1, 1.6, 2.0]])
    truths = poses0 + np.float32([0.05, -0.05, 0.02])
    scans = np.stack([_scan(pairs[a][0], p) for a, p in zip(asg, truths)])
    js = jff.init_pose(poses0, seed=1)
    ts = FleetState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights), seed=0,
                               device="cpu")
    for i in range(steps):
        actions = np.tile(np.float32([0.04, 0.0, 0.02]) * (i + 1), (f, 1))
        u0, noise = _jax_member_draws(js.keys, n)
        js, jposes = jff.step(js, actions, scans)
        ts, tposes = ff.step(ts, actions, scans, u0=u0, noise=noise)
        np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes), rtol=0, atol=1e-3)
        row_ok = np.all(np.abs(ts.particles.numpy() - np.asarray(js.particles)) <= 1e-4, axis=2)
        assert row_ok.mean() >= 0.99, f"step {i}: {row_ok.mean():.3f} rows equal"
    assert ff.likelihood.fleet_launch_count == 0  # CPU tensors: the plain version


def test_fleet_members_localize_on_their_maps():
    """6 cars over 2 stacked maps (tests/test_parallel.py:553): the LUT holds
    2 blocks, every car localizes on its own map, and global init samples
    each member from its own map's free space."""
    jm0, m0 = _map_pair((96, 96, (0.0, 0.0, 0.0), 14))
    jm1, m1 = _map_pair((96, 96, (-3.0, -2.0, 0.0), 15))
    asg = np.array([0, 1, 0, 1, 0, 1], np.int32)
    p0 = np.array([2.4, 2.4, 0.5], np.float32)
    p1 = np.array([-0.9, 0.1, 0.1], np.float32)
    s0, s1 = _scan(jm0, p0), _scan(jm1, p1)
    ff = FleetFilter(stack_maps([m0, m1]), 6, MCLConfig(max_particles=128),
                     beam_angles=BEAMS, map_assignment=asg)
    assert ff.map.range_lut.numel() == 2 * 96 * 96 * ff.map.row_stride
    poses0 = np.stack([p0 if a == 0 else p1 for a in asg])
    scans = np.stack([s0 if a == 0 else s1 for a in asg])
    state = ff.init_pose(poses0, seed=2)
    state, poses = ff.step_many(state, np.zeros((4, 6, 3)), np.stack([scans] * 4))
    err = np.linalg.norm(poses[-1].numpy()[:, :2] - poses0[:, :2], axis=1)
    assert err.max() < 0.25, err
    gs = ff.init_global(seed=3)
    parts = gs.particles.numpy()
    assert parts[0, :, 0].min() >= -0.01 and parts[1, :, 0].min() < 0.0
    for k, a in enumerate(asg):  # every sample on a free cell of its own map
        gm = (m0, m1)[a]
        col = np.round((parts[k, :, 0] - gm.origin_x) / RES).astype(int)
        row = np.round((parts[k, :, 1] - gm.origin_y) / RES).astype(int)
        assert gm.permissible.numpy()[row, col].all()
    assert ((parts[..., 2] >= 0) & (parts[..., 2] < 2 * np.pi)).all()


@pytest.mark.parametrize("stacked", [False, True], ids=["shared_map", "stacked_one_map"])
def test_one_member_fleet_equals_particle_filter(stacked):
    _, gm = _map_pair(MAP_SPECS[0])
    n = 96
    pf = ParticleFilter(gm, MCLConfig(max_particles=n), beam_angles=BEAMS)
    ff = FleetFilter(stack_maps([gm]) if stacked else gm, 1, MCLConfig(max_particles=n),
                     beam_angles=BEAMS)
    assert ff.likelihood.fleet == stacked
    rng = np.random.default_rng(7)
    pose = np.float32([1.0, 1.6, 0.4])
    a = pf.init_pose(pose, seed=4)
    b = ff.init_pose(pose[None], seed=4)
    np.testing.assert_array_equal(a.particles.numpy(), b.particles.numpy()[0])
    for i in range(3):
        scan = rng.uniform(0.3, 5.0, 60).astype(np.float32)
        action = np.float32([0.05, 0.0, 0.03])
        u0 = np.float32(rng.uniform())
        noise = rng.normal(size=(n, 3)).astype(np.float32)
        a, pa = pf.step(a, action, scan, u0=u0, noise=noise)
        b, pb = ff.step(b, action[None], scan[None], u0=u0[None], noise=noise[None])
        np.testing.assert_array_equal(pa.numpy(), pb.numpy()[0])
        np.testing.assert_array_equal(a.particles.numpy(), b.particles.numpy()[0])
        np.testing.assert_array_equal(a.log_weights.numpy(), b.log_weights.numpy()[0])
        assert float(a.log_quality) == float(b.log_quality[0])


def _validation_cases():
    """(name, JAX call, port call) pairs that must both raise ValueError."""
    def maps2(res1=RES):
        occ = _occupancy(48, 48, 9)
        j = [j_map_from_occupancy(occ, RES), j_map_from_occupancy(occ, res1)]
        t = [map_from_occupancy(occ, RES, device="cpu"), map_from_occupancy(occ, res1, device="cpu")]
        return j, t

    def fleet(pkg, asg, f=4):
        j, t = maps2()
        if pkg == "jax":
            return lambda: JFleetFilter(j_stack_maps(j), fleet_size=f, config=JMCLConfig(
                max_particles=64, raycast_method="lut_pallas"), beam_angles=BEAMS,
                map_assignment=asg)
        return lambda: FleetFilter(stack_maps(t), f, MCLConfig(max_particles=64),
                                   beam_angles=BEAMS, map_assignment=asg)

    def resolution(pkg):
        j, t = maps2(res1=0.06)
        return (lambda: j_stack_maps(j)) if pkg == "jax" else (lambda: stack_maps(t))

    def dedup(pkg):
        t_bins = jlut.suggest_theta_bins(BEAMS)
        kw = dict(height=8, width=8, resolution=RES, origin_x=0.0, origin_y=0.0,
                  max_range_px=120, row_stride=jlut.required_row_stride(t_bins, BEAMS),
                  num_members=2, dedup_slots=4, **BEAM_MODEL)
        if pkg == "jax":
            return lambda: jlut.build_lut_query_fn(t_bins, BEAMS, 64, block=8, **kw)
        return lambda: tlut.LUTQuery(t_bins, BEAMS, **kw, device="cpu")

    return {
        "assignment_shape": (fleet("jax", np.array([0, 1, 0])), fleet("torch", np.array([0, 1, 0])),
                             r"map_assignment must be \(4,\)"),
        "assignment_range": (fleet("jax", np.array([0, 1, 2, 1])),
                             fleet("torch", np.array([0, 1, 2, 1])), r"in \[0, 2\)"),
        "map_count": (fleet("jax", None), fleet("torch", None), "pass map_assignment"),
        "resolution": (resolution("jax"), resolution("torch"), "share resolution"),
        "dedup_members": (dedup("jax"), dedup("torch"), "single member"),
    }


@pytest.mark.parametrize("name", ["assignment_shape", "assignment_range", "map_count",
                                  "resolution", "dedup_members"])
def test_validation_errors_mirror_jax(name):
    jax_call, torch_call, match = _validation_cases()[name]
    with pytest.raises(ValueError, match=match):
        jax_call()
    with pytest.raises(ValueError, match=match):
        torch_call()


def test_fleet_construction_errors():
    _, gm = _map_pair(MAP_SPECS[0])
    with pytest.raises(ValueError, match="particle_axis needs a mesh"):
        FleetFilter(gm, 2, MCLConfig(max_particles=64), particle_axis="p")
    with pytest.raises(ValueError, match="map_assignment requires"):
        FleetFilter(gm, 2, MCLConfig(max_particles=64), map_assignment=[0, 0])


class _PathSpy:
    """Counts the plain versions a query call reaches on the CPU: the
    fleet form's (``lut_log_weights_reference`` with fleet tables) and
    the unique-window kernel's (``lut_dedup_reference``)."""

    def __init__(self, monkeypatch):
        self.fleet = self.dedup = 0
        plain, dedup = tlut.lut_log_weights_reference, tlut.lut_dedup_reference

        def spy_plain(q, *args, **kw):
            self.fleet += bool(q.fleet)
            return plain(q, *args, **kw)

        def spy_dedup(*args, **kw):
            self.dedup += 1
            return dedup(*args, **kw)

        monkeypatch.setattr(tlut, "lut_log_weights_reference", spy_plain)
        monkeypatch.setattr(tlut, "lut_dedup_reference", spy_dedup)


@pytest.mark.parametrize("matmul", [False, True], ids=["slots", "slots_matmul"])
@pytest.mark.parametrize("stacked", [False, True], ids=["two_members_one_map", "stacked_two_maps"])
def test_fleet_with_dedup_slots_runs_the_fleet_form(stacked, matmul, monkeypatch):
    """``pallas_dedup_slots`` on a fleet of two members: both packages
    build it and resolve the slots to 0 (JAX ``filter/core.py:329-336``),
    and a step runs the fleet form of the likelihood, not the dedup path,
    with the same rows as the fleet built without the slots."""
    if stacked:
        jm, gm, _ = _stacked(MAP_SPECS[:2])
        asg = np.array([0, 1], np.int32)
    else:
        (jm, gm), asg = _map_pair(MAP_SPECS[0]), None
    base = dict(max_particles=64, raycast_method="lut_pallas")
    cfg = dict(base, pallas_dedup_slots=4, pallas_dedup_matmul=matmul)
    jff = JFleetFilter(jm, fleet_size=2, config=JMCLConfig(**cfg), beam_angles=BEAMS,
                       map_assignment=asg)
    assert jff.fleet_size == 2
    ff = FleetFilter(gm, 2, MCLConfig(**cfg), beam_angles=BEAMS, map_assignment=asg)
    plain = FleetFilter(gm, 2, MCLConfig(**base), beam_angles=BEAMS, map_assignment=asg)
    q = ff.likelihood
    assert q.fleet and q.dedup_slots == 0 and not q.dedup_matmul
    spy = _PathSpy(monkeypatch)
    rng = np.random.default_rng(5)
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.4, 0.9, -0.2]])
    scans = rng.uniform(0.3, 5.0, (2, 60)).astype(np.float32)
    actions = np.float32([[0.04, 0.0, 0.02]] * 2)
    u0 = rng.uniform(size=2).astype(np.float32)
    noise = rng.normal(size=(2, 64, 3)).astype(np.float32)
    got, want = [], []
    for f, out in ((ff, got), (plain, want)):
        state, poses = f.step(f.init_pose(poses0, seed=1), actions, scans, u0=u0, noise=noise)
        out += [state.particles.numpy(), poses.numpy()]
    assert spy.fleet == 2 and spy.dedup == 0
    assert q.fleet_launch_count == q.dedup_launch_count == q.key_launch_count == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_single_filter_keeps_its_dedup_slots():
    """The member count turns the slots off, nothing else: one filter with
    the same config still resolves S = 4 and runs the dedup path."""
    _, gm = _map_pair(MAP_SPECS[0])
    pf = ParticleFilter(gm, MCLConfig(max_particles=64, raycast_method="lut_pallas",
                                      pallas_dedup_slots=4, pallas_dedup_matmul=True),
                        beam_angles=BEAMS)
    assert pf.likelihood.dedup_slots == 4 and pf.likelihood.dedup_matmul


def test_fleet_launch_needs_its_tables():
    """One kernel serves both forms: a fleet query's launch refuses to run
    without its per-map tables, before it reaches the card."""
    t = jlut.suggest_theta_bins(BEAMS)
    stride = jlut.required_row_stride(t, BEAMS, itemsize=1)
    tq = tlut.LUTQuery(t, BEAMS, height=40, width=48, resolution=RES, origin_x=0.0,
                       origin_y=0.0, max_range_px=120, row_stride=stride, num_members=2,
                       **BEAM_MODEL, device="cpu")
    lut, parts, obs = torch.zeros(stride, dtype=torch.uint8), torch.zeros((8, 3)), torch.zeros((2, 60))
    with pytest.raises(ValueError, match="needs its tables"):
        tq.launch(lut, parts, obs)
    tables = tq.fleet_tables(parts, obs)
    assert tables.npm == 4 and tables is tq.fleet_tables(parts, obs)  # built once per shape
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tq.launch(lut, parts, obs, tables=tables)


def test_fleet_ignores_pallas_mega_as_jax_does():
    """A config with ``pallas_mega=True`` drives a fleet as the JAX fleet
    does, which never reads the flag: the classic fleet step, equal to
    the JAX fleet's on its draws and bit-equal to the port's fleet
    without the flag (the flag serves a single filter only)."""
    jm, _, pairs = _stacked(MAP_SPECS[:2])
    f, n = 4, 96
    asg = np.array([0, 1, 1, 0], np.int32)
    cfg = dict(max_particles=n, raycast_method="lut_pallas")
    jff = JFleetFilter(jm, fleet_size=f, config=JMCLConfig(**cfg, pallas_mega=True),
                       beam_angles=BEAMS, map_assignment=asg)
    fleets = {mega: FleetFilter(_carry(jff.map), f, MCLConfig(**cfg, pallas_mega=mega),
                                beam_angles=BEAMS, map_assignment=asg) for mega in (True, False)}
    poses0 = np.float32([[1.0, 1.2, 0.3], [1.5, -0.2, 0.1], [1.2, 0.4, -0.5], [1.1, 1.6, 2.0]])
    scans = np.stack([_scan(pairs[a][0], p + 0.03) for a, p in zip(asg, poses0)])
    js = jff.init_pose(poses0, seed=2)
    states = {mega: FleetState.from_numpy(np.asarray(js.particles), np.asarray(js.log_weights),
                                          seed=0, device="cpu") for mega in fleets}
    for i in range(2):
        actions = np.tile(np.float32([0.03, 0.0, 0.01]), (f, 1))
        u0, noise = _jax_member_draws(js.keys, n)
        js, jposes = jff.step(js, actions, scans)
        out = {}
        for mega, ff in fleets.items():
            states[mega], out[mega] = ff.step(states[mega], actions, scans, u0=u0, noise=noise)
        np.testing.assert_allclose(out[True].numpy(), np.asarray(jposes), rtol=0, atol=1e-3)
        row_ok = np.all(np.abs(states[True].particles.numpy() - np.asarray(js.particles)) <= 1e-4,
                        axis=2)
        assert row_ok.mean() >= 0.99, f"step {i}: {row_ok.mean():.3f} rows equal"
        assert torch.equal(out[True], out[False])
        assert torch.equal(states[True].particles, states[False].particles)
