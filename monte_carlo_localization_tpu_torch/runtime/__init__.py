from monte_carlo_localization_tpu_torch.runtime.checkpoint import (
    load_fleet_state,
    load_state,
    save_fleet_state,
    save_state,
)
from monte_carlo_localization_tpu_torch.runtime.converge import ConvergeResult, converge_global
from monte_carlo_localization_tpu_torch.runtime.fleet_node import FleetNode
from monte_carlo_localization_tpu_torch.runtime.loop import LiveRunner
from monte_carlo_localization_tpu_torch.runtime.node import MCLNode, ReplayResult
from monte_carlo_localization_tpu_torch.runtime.replay import replay_chained
from monte_carlo_localization_tpu_torch.runtime.ros2_bridge import ROS2Bridge
from monte_carlo_localization_tpu_torch.runtime.sinks import (
    CallbackSink,
    JsonlSink,
    NpzSink,
    Sink,
)
from monte_carlo_localization_tpu_torch.runtime.trace import (
    HostRaycaster,
    Trace,
    TraceReader,
    TraceWriter,
    synthesize_trace,
    trace_actions,
)
from monte_carlo_localization_tpu_torch.runtime.tracker import OdometryTracker
from monte_carlo_localization_tpu_torch.runtime.viz import VizSink, map_image, render_frame
from monte_carlo_localization_tpu_torch.runtime.webviz import WebViz

__all__ = [
    "OdometryTracker",
    "MCLNode",
    "FleetNode",
    "ReplayResult",
    "LiveRunner",
    "Sink",
    "CallbackSink",
    "JsonlSink",
    "NpzSink",
    "VizSink",
    "WebViz",
    "ROS2Bridge",
    "map_image",
    "render_frame",
    "Trace",
    "TraceReader",
    "TraceWriter",
    "synthesize_trace",
    "trace_actions",
    "HostRaycaster",
    "save_state",
    "load_state",
    "save_fleet_state",
    "load_fleet_state",
    "ConvergeResult",
    "converge_global",
    "replay_chained",
]
