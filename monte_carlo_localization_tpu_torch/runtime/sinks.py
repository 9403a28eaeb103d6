"""Output sinks — the engine's publication surface; a copy of the JAX
package's ``runtime/sinks.py``, so both packages write the same files
from the same publish calls.

The reference publishes its results over ROS topics with subscriber gating
(TF + ``/pf/pose/odom`` in publish_tf, reference
src/particle_filter.cpp:857-889; ``/pf/viz/inferred_pose`` and
``/pf/viz/particles`` in visualize/publish_particles, reference :923-983,
gated on ``get_subscription_count() > 0`` :928-934).

This module is the ROS-free equivalent: a small ``Sink`` interface with
per-topic gating (``wants(topic)`` is the subscriber-count analogue) and
three implementations — JSONL streaming, buffered NPZ, and callbacks.
Topics:

  ``tf``        map->base_link pose at tick rate        (reference :857-889)
  ``odom``      inferred pose + current twist           (reference :868-886)
  ``pose``      laser-frame inferred pose per correction (reference :936-941)
  ``particles`` weighted-downsampled cloud per correction (reference :944-983)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

TOPICS = ("tf", "odom", "pose", "particles")


class Sink:
    """Interface: override ``publish``; limit topics via ``topics``."""

    topics: frozenset[str] = frozenset(TOPICS)

    def wants(self, topic: str) -> bool:
        """Subscriber-gating analogue (reference :928-934): the node skips
        building payloads no sink wants."""
        return topic in self.topics

    def publish(self, topic: str, t: float, payload: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class CallbackSink(Sink):
    def __init__(self, fn: Callable[[str, float, dict], None],
                 topics: Iterable[str] = TOPICS):
        self.fn = fn
        self.topics = frozenset(topics)

    def publish(self, topic: str, t: float, payload: dict) -> None:
        self.fn(topic, t, payload)


class JsonlSink(Sink):
    """One JSON object per event: {"topic", "t", ...payload}."""

    def __init__(self, path: str | Path, topics: Iterable[str] = TOPICS):
        self.path = Path(path)
        self.topics = frozenset(topics)
        self._f = open(self.path, "w")

    def publish(self, topic: str, t: float, payload: dict) -> None:
        rec = {"topic": topic, "t": float(t)}
        for k, v in payload.items():
            rec[k] = np.asarray(v).tolist() if isinstance(
                v, np.ndarray
            ) else v
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class NpzSink(Sink):
    """Buffers events per topic; writes one compressed npz on close.

    Arrays: ``<topic>_t`` (K,) and ``<topic>_<field>`` stacked over events.
    """

    def __init__(self, path: str | Path, topics: Iterable[str] = TOPICS):
        self.path = Path(path)
        self.topics = frozenset(topics)
        self._buf: dict[str, list] = {}

    def publish(self, topic: str, t: float, payload: dict) -> None:
        self._buf.setdefault(f"{topic}_t", []).append(float(t))
        for k, v in payload.items():
            self._buf.setdefault(f"{topic}_{k}", []).append(np.asarray(v))

    def close(self) -> None:
        arrays = {}
        for k, vals in self._buf.items():
            vs = [np.asarray(v) for v in vals]
            try:
                arrays[k] = np.stack(vs)
            except ValueError:
                # ragged leading dim (e.g. the viz cloud resized mid-run):
                # NaN-pad to the max length and record per-event lengths so
                # nothing is dropped and <topic>_t stays aligned
                n = max(v.shape[0] for v in vs)
                tail = vs[0].shape[1:]
                pad = np.full((len(vs), n, *tail), np.nan, dtype=np.float64)
                for i, v in enumerate(vs):
                    pad[i, : v.shape[0]] = v
                arrays[k] = pad
                arrays[k + "_len"] = np.asarray(
                    [v.shape[0] for v in vs], np.int64
                )
        tmp = self.path.with_name(self.path.name + ".tmp.npz")
        np.savez_compressed(tmp, **arrays)
        tmp.replace(self.path)

    @staticmethod
    def load(path: str | Path) -> dict[str, np.ndarray]:
        z = np.load(Path(path), allow_pickle=False)
        return {k: z[k] for k in z.files}
