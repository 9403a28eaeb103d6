"""tpu-mcl on PyTorch and CUDA: the Monte Carlo Localization correction
of ``monte_carlo_localization_tpu`` for an NVIDIA GPU.

The package mirrors the JAX package's layout and names, imports ``torch``
and never ``jax``, and holds every tensor on an explicit device. The
range-LUT likelihood runs as a hand-written CUDA kernel
(``csrc/lut_likelihood.cu``) on a card and as its plain PyTorch version on
the CPU. ``GridMap.from_numpy`` and ``MCLState.from_numpy`` /
``MCLState.to_numpy`` carry a map (with its LUT buffer) and a particle
cloud across from the JAX package, so both can run on the same inputs.
"""

from monte_carlo_localization_tpu_torch.config import MCLConfig, load_config
from monte_carlo_localization_tpu_torch.filter import MCLState, ParticleFilter
from monte_carlo_localization_tpu_torch.mapping import GridMap, load_map

__all__ = [
    "MCLConfig",
    "load_config",
    "GridMap",
    "load_map",
    "MCLState",
    "ParticleFilter",
]
