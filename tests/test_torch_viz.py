"""The port's PNG renderer (``runtime/viz.py``) against the JAX package's,
case for case with ``tests/test_viz.py``: on one synthetic map the map
underlay, the pixel transform and every rendered frame are equal array
for array; the sink writes the same frames; a node replay renders through
it."""

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.mapping import box_world as j_box_world
from monte_carlo_localization_tpu.runtime import viz as jviz
from monte_carlo_localization_tpu_torch.mapping import box_world
from monte_carlo_localization_tpu_torch.runtime import viz

BOX = dict(height=80, width=100, origin=(-0.4, 0.3, 0.0))


@pytest.fixture(autouse=True)
def _one_thread_private_lut_cache(monkeypatch, tmp_path):
    torch.set_num_threads(1)
    monkeypatch.setenv("MCL_LUT_CACHE", str(tmp_path / "lut_cache"))


@pytest.fixture(scope="module")
def maps():
    return j_box_world(**BOX), box_world(**BOX, device="cpu")


def _center(gm):
    res = gm.resolution
    return (float(gm.origin_x) + 0.5 * gm.width * res, float(gm.origin_y) + 0.5 * gm.height * res)


@pytest.mark.parametrize("scale", [1, 3, None])
def test_map_image_equals_jax(maps, scale):
    jm, tm = maps
    got, want = np.asarray(viz.map_image(tm, scale)), np.asarray(jviz.map_image(jm, scale))
    np.testing.assert_array_equal(got, want)
    h, w = tm.height, tm.width
    s = scale or viz._auto_scale(h, w)
    assert got.shape == (h * s, w * s, 3)
    occ = tm.occupancy.numpy()
    # row 0 of the grid is the image's bottom row (ROS lower-left origin)
    assert (got[-1, ::s, 0] == np.where(occ[0] == 0, 254, np.where(occ[0] > 50, 0, 205))).all()


def test_world_to_px_equals_jax(maps):
    jm, tm = maps
    rng = np.random.default_rng(2)
    xy = rng.uniform(-0.5, 5.0, (32, 2))
    for scale in (1, 4):
        np.testing.assert_array_equal(viz.world_to_px(tm, xy, scale), jviz.world_to_px(jm, xy, scale))
    # the world position of a cell center lands in that pixel
    row, col = 5, 7
    x, y = tm.grid_to_world(row, col)
    (u, v), = viz.world_to_px(tm, np.array([[x + 0.025, y + 0.025]]), scale=1)
    assert (int(u), int(v)) == (col, tm.height - 1 - row)


@pytest.mark.parametrize("weights", [True, False], ids=["weighted", "unweighted"])
def test_render_frame_equals_jax(maps, weights):
    jm, tm = maps
    rng = np.random.default_rng(3)
    cx, cy = _center(tm)
    particles = np.stack([rng.normal(cx, 0.6, 300), rng.normal(cy, 0.5, 300),
                          rng.uniform(-3, 3, 300)], 1).astype(np.float32)
    w = rng.random(300).astype(np.float32) if weights else None
    kw = dict(particles=particles, weights=w, pose=np.array([cx, cy, 0.7]),
              trajectory=np.array([[cx - 0.5, cy - 0.2], [cx - 0.2, cy], [cx, cy]]))
    for scale in (1, 4):
        got = np.asarray(viz.render_frame(tm, **kw, scale=scale))
        want = np.asarray(jviz.render_frame(jm, **kw, scale=scale))
        np.testing.assert_array_equal(got, want)
        assert (got != np.asarray(viz.map_image(tm, scale))).any()  # something was drawn


def test_viz_sink_writes_the_jax_sinks_frames(maps, tmp_path):
    jm, tm = maps
    cx, cy = _center(tm)
    cloud = np.array([[cx, cy, 0.0], [cx + 0.1, cy, 1.0]], np.float32)
    sinks = {"jax": jviz.VizSink(jm, tmp_path / "jax", every=2),
             "port": viz.VizSink(tm, tmp_path / "port", every=2)}
    assert sinks["port"].wants("pose") and sinks["port"].wants("particles")
    assert not sinks["port"].wants("tf")
    for sink in sinks.values():
        for i in range(5):
            sink.publish("particles", float(i), {"cloud": cloud})
            sink.publish("pose", float(i), {"pose": np.array([cx, cy + i * 0.05, 0.0])})
        sink.close()
    from PIL import Image

    names = sorted(p.name for p in (tmp_path / "port").glob("*.png"))
    assert names == ["frame_00001.png", "frame_00003.png", "frame_00005.png", "trajectory.png"]
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.png"))
    assert sinks["port"].frames_written == sinks["jax"].frames_written == 3
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))


def test_node_replay_with_viz_sink(maps, tmp_path):
    """End to end: the port's ``MCLNode`` replay publishes through a VizSink."""
    from monte_carlo_localization_tpu_torch import MCLConfig
    from monte_carlo_localization_tpu_torch.runtime import MCLNode, VizSink, synthesize_trace

    _, tm = maps
    trace = synthesize_trace(tm, duration_s=1.0, num_beams=60, seed=3)
    node = MCLNode(tm, MCLConfig(max_particles=200, raycast_method="lut", lut_theta_bins=180))
    sink = VizSink(tm, tmp_path / "viz", every=5)
    node.add_sink(sink)
    node.initialize_pose(trace.truth_pose[0])
    res = node.replay(trace)
    node.close_sinks()
    assert sink.frames_written == -(-res.corrections // 5) >= 1
    assert (tmp_path / "viz" / "trajectory.png").exists()
