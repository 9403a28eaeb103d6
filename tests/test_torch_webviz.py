"""The port's live viewer (``runtime/webviz.py``), case for case with
``tests/test_webviz.py``: the real HTTP server on port 0 at 127.0.0.1,
driven with urllib (page, frame, state, the press-drag pose estimate and
the global re-initialization, both deferred to the loop's next tick).
The gesture and pixel conversions equal the JAX viewer's on the same
map. Where the JAX viewer serves stale values when the loop has donated
its state away, the port donates nothing, so an error reading the state
propagates instead."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from monte_carlo_localization_tpu.mapping import random_obstacle_world as j_world
from monte_carlo_localization_tpu.runtime import WebViz as JWebViz
from monte_carlo_localization_tpu_torch import MCLConfig
from monte_carlo_localization_tpu_torch.mapping import random_obstacle_world
from monte_carlo_localization_tpu_torch.runtime import MCLNode, WebViz
from monte_carlo_localization_tpu_torch.runtime.viz import world_to_px


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clutter():
    return random_obstacle_world(seed=3, device="cpu")


@pytest.fixture()
def served(clutter):
    node = MCLNode(clutter, MCLConfig(max_particles=128, raycast_method="sphere"), rng_seed=0)
    viz = WebViz(node, clutter, host="127.0.0.1", port=0).start()
    yield node, viz
    viz.close()


def _get(viz, path):
    with urllib.request.urlopen(viz.url.rstrip("/") + path, timeout=10) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _post(viz, path, payload=None):
    req = urllib.request.Request(viz.url.rstrip("/") + path,
                                 data=json.dumps(payload or {}).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, json.loads(r.read() or b"{}")


def test_page_frame_and_state(served):
    node, viz = served
    assert viz.url.startswith("http://127.0.0.1:") and viz.port > 0
    code, body, ctype = _get(viz, "/")
    assert code == 200 and b"tpu-mcl" in body and "html" in ctype
    code, png, ctype = _get(viz, "/frame.png")
    assert code == 200 and png[:4] == b"\x89PNG" and ctype == "image/png"
    code, body, _ = _get(viz, "/state.json")
    s = json.loads(body)
    assert len(s["pose"]) == 3 and np.isfinite(s["pose"]).all()
    assert s["iters"] == node.iters and np.isfinite(s["log_quality"])


def test_drag_gesture_sets_pose_estimate(served):
    node, viz = served
    target = np.array([10.0, 10.0])
    (u0, v0), = world_to_px(viz.gm, target[None], viz.scale)
    code, out = _post(viz, "/initialpose", dict(u0=u0, v0=v0, u1=u0 + 30.0, v1=v0))
    assert code == 200
    np.testing.assert_allclose(out["pose"][:2], target, atol=0.1)
    assert abs(out["pose"][2]) < 1e-6
    node.update()  # the re-init applies at the next tick
    cloud = node.state.particles.numpy()
    assert np.linalg.norm(cloud[:, :2].mean(0) - target) < 0.3
    code, out = _post(viz, "/initialpose", dict(u0=u0, v0=v0, u1=u0, v1=v0 - 30.0))
    assert abs(out["pose"][2] - np.pi / 2) < 1e-6  # upward drag: image v is flipped


def test_world_coord_pose_and_global(served):
    node, viz = served
    code, out = _post(viz, "/initialpose", dict(x=8.0, y=9.0, theta=0.7))
    assert code == 200 and out["pose"] == [8.0, 9.0, 0.7]
    node.update()
    spread_seeded = node.state.particles[:, 0].std().item()
    code, _ = _post(viz, "/global")
    assert code == 200
    node.update()
    assert node.state.particles[:, 0].std().item() > 3 * spread_seeded


def test_bad_requests(served):
    _, viz = served
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(viz, "/initialpose", dict(u0=1.0))  # missing coordinates
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(viz, "/nope")
    assert e.value.code == 404


def test_reinit_is_deferred_to_the_loop_thread(served):
    """A POSTed re-init never touches the state from the HTTP thread; it
    queues and applies at the top of the next update() tick."""
    node, viz = served
    before = node.state.particles.clone()
    code, _ = _post(viz, "/initialpose", dict(x=5.0, y=5.0, theta=0.1))
    assert code == 200
    assert torch.equal(node.state.particles, before) and node._pending_reinit is not None
    node.update()
    assert node._pending_reinit is None
    assert np.linalg.norm(node.state.particles[:, :2].mean(0).numpy() - [5.0, 5.0]) < 0.3


def test_state_read_errors_propagate(served):
    """The port's loop replaces its state and never frees the old one, so
    there is no donated-buffer race to serve stale values over (the JAX
    viewer's ``test_state_json_survives_deleted_buffer``): an error
    reading the state reaches the request instead of stale output."""
    node, viz = served

    class Broken:
        @property
        def particles(self):
            raise RuntimeError("buffer was deleted")

        @property
        def log_quality(self):
            raise RuntimeError("buffer was deleted")

    code, _, _ = _get(viz, "/state.json")
    assert code == 200
    node.state = Broken()
    with pytest.raises(RuntimeError, match="deleted"):
        viz._state()
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        _get(viz, "/state.json")


def test_gestures_and_pixels_equal_the_jax_viewer(clutter):
    """The same payloads give the same poses and the same pixel -> world
    points in both viewers, on the same map."""
    jviz = JWebViz(None, j_world(seed=3), port=0)
    tviz = WebViz(None, clutter, port=0)
    try:
        assert tviz.scale == jviz.scale
        payloads = [dict(x=3.5, y=-1.25, theta=2.0), dict(x=1, y=2),
                    dict(u0=100.5, v0=200.25, u1=130.0, v1=180.0),
                    dict(u0=10.0, v0=20.0, u1=10.5, v1=20.5)]
        for p in payloads:
            np.testing.assert_array_equal(tviz._pose_from_payload(p), jviz._pose_from_payload(p))
        for xy in ([3.2, 4.1], [10.0, 10.0], [0.6, 17.3]):
            (u, v), = world_to_px(tviz.gm, np.asarray(xy)[None], tviz.scale)
            np.testing.assert_allclose(tviz._px_to_world(u, v), xy, atol=1e-6)
            np.testing.assert_allclose(tviz._px_to_world(u, v), jviz._px_to_world(u, v),
                                       rtol=1e-6, atol=0)
    finally:
        for v in (jviz, tviz):
            v._server.server_close()
