"""The port's ray casters against the JAX package's, and the port's own
native source.

``cast_rays_dda`` (the oracle that makes scans) and ``cast_rays_sphere``
(config #4's scan synthesizer) run on one seeded map, carried across with
``GridMap.from_numpy``, and the same seeded queries. Both sides are
float32 with the same truncating world-to-grid casts; ``cos``/``sin``
may differ by an ulp, which can move a grazing ray by one step. So at
least 99% of rays must agree within 1e-5 m and every ray within one
cell.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from monte_carlo_localization_tpu.mapping import random_obstacle_world
from monte_carlo_localization_tpu.ops import raycast as jray
from monte_carlo_localization_tpu_torch import GridMap, native
from monte_carlo_localization_tpu_torch.ops import raycast as tray

PKG = Path(__file__).resolve().parents[1] / "monte_carlo_localization_tpu_torch"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def maps():
    jm = random_obstacle_world(height=80, width=112, num_obstacles=6, seed=11)
    tm = GridMap.from_numpy(
        occupancy=np.asarray(jm.occupancy), free_cells=np.asarray(jm.free_cells),
        num_free=int(jm.num_free), clearance=np.asarray(jm.clearance),
        origin_x=float(jm.origin_x), origin_y=float(jm.origin_y),
        resolution=jm.resolution, max_range_px=jm.max_range_px,
        max_range_meters=jm.max_range_meters, device="cpu",
    )
    return jm, tm


def _queries(jm, n, seed):
    rng = np.random.default_rng(seed)
    free = np.asarray(jm.free_cells[: int(jm.num_free)])
    rc = free[rng.integers(len(free), size=n)]
    x = (rc[:, 1] + rng.uniform(0.05, 0.95, n)) * jm.resolution + float(jm.origin_x)
    y = (rc[:, 0] + rng.uniform(0.05, 0.95, n)) * jm.resolution + float(jm.origin_y)
    a = rng.uniform(-np.pi, np.pi, n)
    return np.stack([x, y, a], 1).astype(np.float32)


@pytest.mark.parametrize(
    "cast",
    [("cast_rays_dda", {}), ("cast_rays_sphere", dict(num_iters=48)),
     ("cast_rays_sphere", dict(num_iters=64))],
    ids=["dda", "sphere48", "sphere64"],
)
def test_matches_jax_caster(maps, cast):
    name, kw = cast
    jm, tm = maps
    q = _queries(jm, 600, seed=len(kw) + kw.get("num_iters", 0))
    want = np.asarray(getattr(jray, name)(jm, jnp.asarray(q), **kw))
    got = getattr(tray, name)(tm, torch.from_numpy(q), **kw).numpy()
    assert got.dtype == np.float32 and got.shape == (600,)
    close = np.abs(got - want) <= 1e-5
    assert close.mean() >= 0.99, close.mean()
    assert np.abs(got - want).max() <= jm.resolution + 1e-5
    assert (got > 0).any() and (got < jm.max_range_meters).any()


def test_sphere_agrees_with_dda_oracle(maps):
    _, tm = maps
    q = torch.from_numpy(_queries(maps[0], 400, seed=5))
    dda = tray.cast_rays_dda(tm, q)
    sphere = tray.cast_rays_sphere(tm, q, num_iters=64)
    # the two differ by design on grazing and corner rays (~2 px)
    assert float(((sphere - dda).abs() <= 2 * tm.resolution + 1e-5).float().mean()) >= 0.97


def test_native_source_is_the_ports_own():
    src = Path(native._SRC).resolve()
    assert src.is_relative_to(PKG.resolve()) and src.exists()
    jax_src = PKG.parent / "monte_carlo_localization_tpu" / "native" / "mcl_native.cpp"
    assert src.read_bytes() == jax_src.read_bytes()
