"""The motion phase's kernel on a card: ``csrc/motion.cu``, the resampled
rows' gather and ``models/motion.py``'s arc motion and noise in one
launch, one thread a particle and one launch for every row of a fleet.

:data:`MOTION_KERNEL` counts its launches (``launch_count``) and the
calls off a card, which take the plain PyTorch version
(``plain_launch_count``);
``TRACER.summary()`` shows them as ``motion.kernel`` and ``motion.plain``.
The programs that run motion list it among their wrappers, so a graph's
replays add theirs (``utils/graphs.py`` ``LaunchCounters``).
"""

from __future__ import annotations

import torch

from monte_carlo_localization_tpu_torch.utils.timing import TRACER


class MotionKernel:
    """``csrc/motion.cu``: ``motion_model_plain(gather_rows(particles, indices),
    action, ..., noise=noise)`` bit for bit, for (N, 3) particles with a
    (3,) action or a fleet's (F, N, 3) with (3,) or (F, 3) actions, the
    noise read by its strides. Each launch adds one to ``launch_count``;
    ``plain_launch_count`` counts ``motion_model``'s calls off a card,
    which take the plain version (its name ends so that a graph's
    replays add theirs too)."""

    def __init__(self):
        self.launch_count = 0
        self.plain_launch_count = 0

    def __call__(self, particles: torch.Tensor, action: torch.Tensor,
                 noise: torch.Tensor | None, dispersion: tuple[float, float, float],
                 exact_dt_heuristic: bool = True, indices: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """The proposal (..., M, 3) from particles (..., N, 3), the action,
        noise shaped like the proposal (None: drawn from ``generator``
        once the inputs pass) and int32 source ``indices`` (..., M) (None:
        slot i moves particle i). Raises ``ValueError`` on anything else,
        before any launch."""
        if not isinstance(action, torch.Tensor):
            raise ValueError(f"motion kernel needs the action as a tensor, got {type(action)}")
        rank = particles.dim()
        if rank not in (2, 3) or particles.shape[-1] != 3 or particles.numel() == 0:
            raise ValueError(f"motion kernel takes (N, 3) or (F, N, 3) particles, got "
                             f"{tuple(particles.shape)}")
        rows = particles.shape[0] if rank == 3 else 1
        if tuple(action.shape) not in ((3,), (rows, 3)) or (rank == 2 and action.dim() != 1):
            raise ValueError(f"action shape {tuple(action.shape)} does not fit "
                             f"{tuple(particles.shape)} particles")
        if indices is not None and (indices.dim() != rank - 1 or indices.shape[-1] < 1
                                    or tuple(indices.shape[:-1]) != tuple(particles.shape[:-2])):
            raise ValueError(f"indices shape {tuple(indices.shape)} does not fit "
                             f"{tuple(particles.shape)} particles")
        # the moved rows: the particles', or one row a source index
        shape = tuple(particles.shape) if indices is None else tuple(indices.shape) + (3,)
        if noise is not None and tuple(noise.shape) != shape:
            raise ValueError(f"noise shape {tuple(noise.shape)} != {shape}")
        noise_dtype = particles.dtype if noise is None else noise.dtype
        if particles.dtype != torch.float32 or action.dtype != torch.float32 \
                or noise_dtype != torch.float32:
            raise ValueError(f"motion kernel needs float32 particles, action and noise, got "
                             f"{particles.dtype}, {action.dtype}, {noise_dtype}")
        if indices is not None and indices.dtype != torch.int32:
            raise ValueError(f"motion kernel needs int32 indices, got {indices.dtype}")
        if not particles.is_contiguous():
            raise ValueError("motion kernel needs contiguous particles")
        dev = particles.device
        if dev.type != "cuda" or any(t is not None and t.device != dev
                                     for t in (action, noise, indices)):
            raise ValueError(f"motion kernel needs every input on one CUDA device, got "
                             f"particles on {dev}")
        if noise is None:
            noise = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        from monte_carlo_localization_tpu_torch.ops._cuda_build import load_library

        m = shape[-2]
        # per row, slot and axis; a shared (3,) action or a lone row has row stride 0
        act_row, act_col = (action.stride(0), action.stride(1)) if action.dim() == 2 \
            else (0, action.stride(0))
        noise_row = noise.stride(0) if rank == 3 else 0
        idx_row = indices.stride(0) if indices is not None and rank == 3 else 0
        idx_col = indices.stride(-1) if indices is not None else 0
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        built = load_library()
        with torch.cuda.device(dev):
            err = built.libs["motion"].mcl_motion(
                particles.data_ptr(), rows, particles.shape[-2], m,
                None if indices is None else indices.data_ptr(), idx_row, idx_col,
                action.data_ptr(), act_row, act_col,
                noise.data_ptr(), noise_row, noise.stride(-2), noise.stride(-1),
                float(dispersion[0]), float(dispersion[1]), float(dispersion[2]),
                int(bool(exact_dt_heuristic)), out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"motion launch failed: CUDA error {err} "
                               f"({built.error_string(err)})")
        self.launch_count += 1
        return out


MOTION_KERNEL = MotionKernel()
TRACER.counter("motion.kernel", lambda: MOTION_KERNEL.launch_count)
TRACER.counter("motion.plain", lambda: MOTION_KERNEL.plain_launch_count)
