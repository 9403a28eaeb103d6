"""Occupancy-grid map: loading, preprocessing and device residency, as in
the JAX package's ``mapping/grid_map.py``.

Semantics kept from the reference ROS map_server path: occupancy values
0 free / 100 occupied / -1 unknown; ``permissible`` (free space for
initialization) is ``occupancy == 0``; rays stop at ``occupancy > 50``;
the origin yaw is stored but ignored by grid <-> world transforms.

A :class:`GridMap` holds its arrays as tensors on one device, chosen
explicitly by the ``device`` argument of its constructors. Map and LUT
preprocessing runs on the host (numpy, native C++) and is uploaded once.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import yaml

from monte_carlo_localization_tpu_torch.mapping.edt import clearance_field

OCC_FREE = 0
OCC_OCCUPIED = 100
OCC_UNKNOWN = -1
OCC_THRESHOLD = 50

# Largest dense padded LUT before a filter switches to the row-compacted
# one, overridable by MCL_LUT_DENSE_MAX (the JAX filter's rule).
LUT_DENSE_MAX_DEFAULT = 2 << 30


def _upload(arr: np.ndarray, device, dtype=None) -> torch.Tensor:
    """Host array -> tensor on ``device`` (one copy for a read-only or
    non-contiguous array, e.g. an mmap'd cache entry)."""
    arr = np.asarray(arr, dtype=dtype)
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr).to(device)


@dataclass(frozen=True)
class GridMap:
    """Immutable occupancy-grid map whose tensors live on one device."""

    occupancy: torch.Tensor  # (H, W) int8, trinary ROS values
    occupied: torch.Tensor  # (H, W) bool, occupancy > 50
    permissible: torch.Tensor  # (H, W) bool, occupancy == 0
    clearance: torch.Tensor  # (H, W) float32, px to obstacle/border
    free_cells: torch.Tensor  # (K, 2) int32 (row, col) of free cells
    num_free: int  # count of real free cells (K may be padded)
    # origins as Python floats holding the float32 values the JAX map keeps
    origin_x: float
    origin_y: float
    origin_yaw: float  # stored, unused (as the reference)
    resolution: float  # m / px
    max_range_px: int
    max_range_meters: float
    name: str = ""
    # Flat range LUT (rows * row_stride entries, u8/u16) or None.
    range_lut: torch.Tensor | None = None
    # Compact LUT indirection: (H*W,) int32 cell -> LUT row (row 0 is the
    # shared far row). None for a dense LUT (row == cell).
    lut_row_map: torch.Tensor | None = None
    lut_theta_bins: int = 0
    # entries per LUT row; 0 means lut_theta_bins (the JAX convention)
    lut_row_stride: int = 0

    @property
    def device(self) -> torch.device:
        return self.occupancy.device

    @property
    def height(self) -> int:
        return self.occupancy.shape[-2]

    @property
    def width(self) -> int:
        return self.occupancy.shape[-1]

    @property
    def row_stride(self) -> int:
        return self.lut_row_stride or self.lut_theta_bins

    def to(self, device: torch.device | str) -> "GridMap":
        """This map with every tensor on ``device`` (itself if already)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            },
        )

    @classmethod
    def from_numpy(
        cls,
        *,
        occupancy: np.ndarray,
        free_cells: np.ndarray,
        num_free: int,
        clearance: np.ndarray,
        origin_x: float,
        origin_y: float,
        resolution: float,
        max_range_px: int,
        origin_yaw: float = 0.0,
        max_range_meters: float | None = None,
        name: str = "",
        range_lut: np.ndarray | None = None,
        lut_row_map: np.ndarray | None = None,
        lut_theta_bins: int = 0,
        lut_row_stride: int = 0,
        device: torch.device | str = "cpu",
    ) -> "GridMap":
        """A map from host arrays, e.g. the JAX package's ``GridMap``
        fields converted with ``np.asarray``, so both packages can run on
        one LUT buffer. ``range_lut`` is flattened to the (rows *
        row_stride,) layout."""
        occupancy = np.asarray(occupancy, np.int8)
        if range_lut is not None:
            range_lut = np.asarray(range_lut).reshape(-1)
            if range_lut.dtype not in (np.uint8, np.uint16):
                raise ValueError(f"range_lut dtype {range_lut.dtype} is not u8/u16")
            stride = lut_row_stride or lut_theta_bins
            if stride <= 0 or range_lut.size % stride:
                raise ValueError(
                    f"range_lut of {range_lut.size} entries is not whole rows "
                    f"of {stride}"
                )
        if max_range_meters is None:
            max_range_meters = max_range_px * float(resolution)
        return cls(
            occupancy=_upload(occupancy, device),
            occupied=_upload(occupancy > OCC_THRESHOLD, device),
            permissible=_upload(occupancy == OCC_FREE, device),
            clearance=_upload(clearance, device, np.float32),
            free_cells=_upload(free_cells, device, np.int32),
            num_free=int(num_free),
            origin_x=float(np.float32(origin_x)),
            origin_y=float(np.float32(origin_y)),
            origin_yaw=float(np.float32(origin_yaw)),
            resolution=float(resolution),
            max_range_px=int(max_range_px),
            max_range_meters=float(max_range_meters),
            name=name,
            range_lut=None if range_lut is None else _upload(range_lut, device),
            lut_row_map=(
                None if lut_row_map is None
                else _upload(np.asarray(lut_row_map).reshape(-1), device, np.int32)
            ),
            lut_theta_bins=int(lut_theta_bins),
            lut_row_stride=int(lut_row_stride),
        )

    def with_range_lut(
        self,
        t_bins: int | None = None,
        use_cache: bool = True,
        row_stride: int = 0,
    ) -> "GridMap":
        """A copy with the dense angle-quantized range LUT attached, built
        on the host and uploaded once. With ``row_stride > t_bins`` each row
        is padded with angle-wraparound content."""
        from monte_carlo_localization_tpu_torch.mapping.range_lut import (
            DEFAULT_THETA_BINS,
            build_range_lut,
            cached_range_lut,
        )

        t = t_bins or DEFAULT_THETA_BINS
        stride = row_stride or t
        if stride < t:
            raise ValueError(f"row_stride {stride} < t_bins {t}")
        if (
            self.range_lut is not None
            and self.lut_row_map is None
            and self.lut_theta_bins == t
            and self.row_stride == stride
        ):
            return self
        build = cached_range_lut if use_cache else build_range_lut
        lut = build(self.occupied.cpu().numpy(), t, self.max_range_px, row_stride=stride)
        return dataclasses.replace(
            self,
            range_lut=_upload(np.asarray(lut).reshape(-1), self.device),
            lut_row_map=None,
            lut_theta_bins=t,
            lut_row_stride=stride if stride != t else 0,
        )

    def with_compact_range_lut(self, t_bins: int, row_stride: int = 0) -> "GridMap":
        """A copy with the row-compacted range LUT attached (giant maps,
        e.g. Spielberg): cells with clearance >= max_range share one
        constant far row; the rest get real rows through ``lut_row_map``.
        Built on the host by the native C++ builder, uploaded once."""
        from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
        from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
            FAR_ROW_MARGIN,
            compact_row_map,
        )
        from monte_carlo_localization_tpu_torch.native import (
            native_build_compact_range_lut,
        )

        stride = row_stride or t_bins
        if (
            self.range_lut is not None
            and self.lut_row_map is not None
            and self.lut_theta_bins == t_bins
            and self.row_stride == stride
        ):
            return self
        occupied = self.occupied.cpu().numpy()
        # the stored clearance is clipped at max_range_px + 1, which
        # saturates the far-row test: recompute with headroom
        clearance = clearance_field(
            occupied, self.max_range_px + FAR_ROW_MARGIN + 2
        )
        row_map, _ = compact_row_map(clearance, self.max_range_px)
        lut = native_build_compact_range_lut(
            occupied, t_bins, self.max_range_px, row_map, stride,
            dtype=lut_dtype(self.max_range_px),
        )
        if lut is None:
            raise RuntimeError(
                "the compact range LUT needs the native builder (g++ with "
                "OpenMP), which is unavailable"
            )
        return dataclasses.replace(
            self,
            range_lut=_upload(lut.reshape(-1), self.device),
            lut_row_map=_upload(row_map, self.device),
            lut_theta_bins=t_bins,
            lut_row_stride=stride if stride != t_bins else 0,
        )

    def with_kernel_lut(self, t_bins: int, row_stride: int, itemsize: int) -> "GridMap":
        """Attach the LUT the fused likelihood reads: dense when the padded
        LUT fits ``MCL_LUT_DENSE_MAX`` bytes (default 2 GiB), row-compacted
        beyond (the JAX filter's choice, ``filter/core.py:238-276``)."""
        dense_bytes = self.height * self.width * row_stride * itemsize
        max_dense = int(os.environ.get("MCL_LUT_DENSE_MAX", LUT_DENSE_MAX_DEFAULT))
        if dense_bytes > max_dense:
            return self.with_compact_range_lut(t_bins, row_stride)
        return self.with_range_lut(t_bins, row_stride=row_stride)


def occupancy_from_image(
    image: np.ndarray,
    negate: int = 0,
    occupied_thresh: float = 0.65,
    free_thresh: float = 0.196,
) -> np.ndarray:
    """ROS map_server trinary conversion of a grayscale image, flipped so
    occupancy row 0 is the bottom (world origin side) of the picture."""
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 3:  # RGB(A) -> luminance mean, as map_server does
        img = img[..., :3].mean(axis=-1)
    p = img / 255.0 if negate else (255.0 - img) / 255.0
    occ = np.full(img.shape, OCC_UNKNOWN, dtype=np.int8)
    occ[p > occupied_thresh] = OCC_OCCUPIED
    occ[p < free_thresh] = OCC_FREE
    return np.flipud(occ).copy()


def map_from_occupancy(
    occupancy: np.ndarray,
    resolution: float,
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0),
    max_range_meters: float = 12.0,
    name: str = "",
    device: torch.device | str = "cpu",
) -> GridMap:
    """A GridMap on ``device`` from a raw int8 occupancy array."""
    occupancy = np.asarray(occupancy, dtype=np.int8)
    max_range_px = int(max_range_meters / resolution)
    clearance = clearance_field(occupancy > OCC_THRESHOLD, max_range_px)
    rows, cols = np.nonzero(occupancy == OCC_FREE)
    free_cells = np.stack([rows, cols], axis=1).astype(np.int32)
    if free_cells.shape[0] == 0:
        raise ValueError(f"Map {name!r} has no free space")
    return GridMap.from_numpy(
        occupancy=occupancy,
        free_cells=free_cells,
        num_free=free_cells.shape[0],
        clearance=clearance,
        origin_x=origin[0],
        origin_y=origin[1],
        origin_yaw=origin[2],
        resolution=float(resolution),
        max_range_px=max_range_px,
        max_range_meters=float(max_range_meters),
        name=name,
        device=device,
    )


def _read_image(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def load_map(
    yaml_path: str | Path,
    max_range_meters: float = 12.0,
    device: torch.device | str = "cpu",
) -> GridMap:
    """Load a ROS-style map YAML + image pair (image, resolution, origin
    [x, y, yaw], negate, occupied_thresh, free_thresh) onto ``device``."""
    yaml_path = Path(yaml_path)
    with open(yaml_path) as f:
        meta: dict[str, Any] = yaml.safe_load(f)

    image_path = Path(meta["image"])
    if not image_path.is_absolute():
        image_path = yaml_path.parent / image_path

    occupancy = occupancy_from_image(
        _read_image(image_path),
        negate=int(meta.get("negate", 0)),
        occupied_thresh=float(meta.get("occupied_thresh", 0.65)),
        free_thresh=float(meta.get("free_thresh", 0.196)),
    )
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    return map_from_occupancy(
        occupancy,
        resolution=float(meta["resolution"]),
        origin=(float(origin[0]), float(origin[1]), float(origin[2])),
        max_range_meters=max_range_meters,
        name=yaml_path.stem,
        device=device,
    )
