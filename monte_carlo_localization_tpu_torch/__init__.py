"""tpu-mcl on PyTorch and CUDA: the Monte Carlo Localization correction
of ``monte_carlo_localization_tpu`` for an NVIDIA GPU.

The package mirrors the JAX package's layout and names, imports ``torch``
and never ``jax``, and holds every tensor on one device: the card by
default, the CPU where the caller passes ``device="cpu"``. The range-LUT
likelihood runs as a hand-written CUDA kernel (``csrc/lut_likelihood.cu``)
on a card and as its plain PyTorch version on the CPU; with
``MCLConfig(pallas_mega=True)``, ``ParticleFilter.step_many`` runs each
correction as one launch of the mega-step kernel (``csrc/mega_step.cu``). ``GridMap.from_numpy`` and ``MCLState.from_numpy`` /
``MCLState.to_numpy`` carry a map (with its LUT buffer) and a particle
cloud across from the JAX package, so both can run on the same inputs.
On a card ``ParticleFilter.step`` / ``step_many``, the mega step's chain
and ``FleetFilter.step`` / ``step_many`` replay CUDA graphs captured on
first use, the counterpart of the JAX package's ``jax.jit``;
``disable_graphs()`` runs them eagerly, as ``jax.disable_jit()`` does.

``runtime`` holds the single-filter node (``MCLNode``: the dual-rate
tracker, sinks, checkpoints, Augmented-MCL re-localization), the fleet
robot loop (``FleetNode``), their live scheduler (``LiveRunner``) and the
I/O modules (PNG frames, the HTTP viewer, rosbag2 files, the optional ROS2
bridge); ``python -m monte_carlo_localization_tpu_torch.cli`` is the
command line (``make-trace``, ``replay``, ``live``, ``info``,
``export-bag``, ``import-bag``).
"""

from monte_carlo_localization_tpu_torch.config import MCLConfig, load_config
from monte_carlo_localization_tpu_torch.filter import (
    MCLState,
    MegaStepper,
    ParticleFilter,
    mega_supported,
)
from monte_carlo_localization_tpu_torch.mapping import GridMap, load_map
from monte_carlo_localization_tpu_torch.runtime import LiveRunner, MCLNode, Trace
from monte_carlo_localization_tpu_torch.utils.graphs import disable_graphs

__version__ = "0.1.0"  # the JAX package's version, which this port mirrors

__all__ = [
    "MCLConfig",
    "load_config",
    "GridMap",
    "load_map",
    "MCLState",
    "ParticleFilter",
    "MegaStepper",
    "mega_supported",
    "MCLNode",
    "LiveRunner",
    "Trace",
    "disable_graphs",
    "__version__",
]
