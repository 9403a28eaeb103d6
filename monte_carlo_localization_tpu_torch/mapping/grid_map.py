"""Occupancy-grid map: loading, preprocessing and device residency, as in
the JAX package's ``mapping/grid_map.py``.

Semantics kept from the reference ROS map_server path: occupancy values
0 free / 100 occupied / -1 unknown; ``permissible`` (free space for
initialization) is ``occupancy == 0``; rays stop at ``occupancy > 50``;
the origin yaw is stored but ignored by grid <-> world transforms.

A :class:`GridMap` holds its arrays as tensors on one device, chosen by
the ``device`` argument of its constructors (default: the card). Map and LUT
preprocessing runs on the host (numpy, native C++) and is uploaded once.

A batched (fleet) map, made by ``parallel.stack_maps``, has a leading map
axis on every grid, per-map origins and free-cell counts as tensors, and
the true per-map shapes in ``member_dims``; its LUT is one flat buffer of
tight per-map blocks (:meth:`GridMap.with_member_luts`,
:meth:`GridMap.with_member_compact_luts`).
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
from monte_carlo_localization_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

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
    """Immutable occupancy-grid map whose tensors live on one device.

    A batched map (M maps) has (M, ...) grids and free cells, (M,) float32
    origin tensors and an (M,) int32 ``num_free`` tensor."""

    occupancy: torch.Tensor  # (H, W) int8, trinary ROS values
    occupied: torch.Tensor  # (H, W) bool, occupancy > 50
    permissible: torch.Tensor  # (H, W) bool, occupancy == 0
    clearance: torch.Tensor  # (H, W) float32, px to obstacle/border
    free_cells: torch.Tensor  # (K, 2) int32 (row, col) of free cells
    num_free: int | torch.Tensor  # count of real free cells (K may be padded)
    # origins as Python floats holding the float32 values the JAX map
    # keeps; (M,) float32 tensors on a batched map
    origin_x: float | torch.Tensor
    origin_y: float | torch.Tensor
    origin_yaw: float | torch.Tensor  # stored, unused (as the reference)
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
    # Batched maps only: (M, 2) int32 true (height, width) of each map
    # before stack_maps padded it; (M,) int32 start of each map's LUT
    # block in 512 B subrow units; (M,) int32 start of each map's cells in
    # the concatenated compact row map.
    member_dims: torch.Tensor | None = None
    lut_member_base: torch.Tensor | None = None
    lut_row_map_base: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.occupancy.device

    @property
    def is_batched(self) -> bool:
        return self.occupancy.dim() == 3

    @property
    def num_maps(self) -> int:
        return self.occupancy.shape[0] if self.is_batched else 1

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
        member_dims: np.ndarray | None = None,
        lut_member_base: np.ndarray | None = None,
        lut_row_map_base: np.ndarray | None = None,
        device: torch.device | str = DEFAULT_DEVICE,
    ) -> "GridMap":
        """A map from host arrays, e.g. the JAX package's ``GridMap``
        fields converted with ``np.asarray``, so both packages can run on
        one LUT buffer. ``range_lut`` is flattened to the (rows *
        row_stride,) layout. A batched map passes (M, H, W) grids, (M,)
        origins and free-cell counts, and its member dims and LUT bases."""
        device = resolve_device(device)
        occupancy = np.asarray(occupancy, np.int8)
        batched = occupancy.ndim == 3
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
            num_free=_upload(num_free, device, np.int32) if batched else int(num_free),
            origin_x=_per_map(origin_x, batched, device),
            origin_y=_per_map(origin_y, batched, device),
            origin_yaw=_per_map(origin_yaw, batched, device),
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
            member_dims=_optional_int32(member_dims, device),
            lut_member_base=_optional_int32(lut_member_base, device),
            lut_row_map_base=_optional_int32(lut_row_map_base, device),
        )

    def _require_single(self, what: str) -> None:
        if self.is_batched:
            raise ValueError(
                f"{what} takes a single map; a batched map attaches tight "
                "per-map LUTs (with_member_luts / with_member_compact_luts)"
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

        self._require_single("with_range_lut")
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

        self._require_single("with_compact_range_lut")
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

    def _member_dims_np(self) -> np.ndarray:
        """(M, 2) int64 true (height, width) of each map of a batched map;
        the padded common shape where ``member_dims`` is absent."""
        if self.member_dims is not None:
            return self.member_dims.cpu().numpy().astype(np.int64)
        return np.tile(np.asarray(self.occupancy.shape[1:], np.int64), (self.num_maps, 1))

    def _check_member_geometry(self, what: str, t_bins: int, row_stride: int,
                               subrow_entries: int) -> None:
        if not self.is_batched:
            raise ValueError(f"{what} needs a batched (M, H, W) map")
        if row_stride < t_bins or row_stride % subrow_entries != 0:
            raise ValueError(
                f"row_stride {row_stride} must be >= t_bins {t_bins} and a "
                f"multiple of subrow_entries {subrow_entries}"
            )

    def with_member_luts(
        self,
        t_bins: int,
        row_stride: int,
        subrow_entries: int,
        use_cache: bool = True,
    ) -> "GridMap":
        """Batched maps: attach tight dense per-map LUTs (the JAX
        ``GridMap.with_member_luts``). Each map's LUT is built on the host
        at its true shape (``member_dims``) and the blocks are concatenated
        into one flat buffer; ``lut_member_base`` holds each block's start
        in ``subrow_entries``-entry (512 B) subrows. Memory is the sum of
        the true map areas."""
        from monte_carlo_localization_tpu_torch.mapping.range_lut import (
            build_range_lut,
            cached_range_lut,
        )

        self._check_member_geometry("with_member_luts", t_bins, row_stride, subrow_entries)
        if (
            self.range_lut is not None
            and self.lut_member_base is not None
            and self.lut_row_map is None
            and self.lut_theta_bins == t_bins
            and self.row_stride == row_stride
        ):
            return self
        occupied = self.occupied.cpu().numpy()
        dims = self._member_dims_np()
        build = cached_range_lut if use_cache else build_range_lut
        spe = row_stride // subrow_entries  # subrows per LUT row
        blocks, bases, at = [], np.zeros(self.num_maps, np.int64), 0
        for i, (h, w) in enumerate(dims.tolist()):
            bases[i] = at
            lut = build(occupied[i, :h, :w], t_bins, self.max_range_px, row_stride=row_stride)
            blocks.append(np.asarray(lut).reshape(-1))
            at += h * w * spe
        if at > np.iinfo(np.int32).max:
            raise ValueError(
                f"tight fleet LUT subrow index ({at}) overflows int32; use "
                "fewer or smaller maps"
            )
        return dataclasses.replace(
            self,
            range_lut=_upload(np.concatenate(blocks), self.device),
            lut_row_map=None,
            lut_row_map_base=None,
            lut_theta_bins=t_bins,
            lut_row_stride=row_stride if row_stride != t_bins else 0,
            lut_member_base=_upload(bases, self.device, np.int32),
        )

    def with_member_compact_luts(
        self, t_bins: int, row_stride: int, subrow_entries: int
    ) -> "GridMap":
        """Batched maps: attach row-compacted tight per-map LUTs (the JAX
        ``GridMap.with_member_compact_luts``), built on the host by the
        native C++ builder for u8 and u16. Map i's cell maps through
        ``lut_row_map[lut_row_map_base[i] + cell]`` to its block-local
        compact row (row 0 the block's far row), and the block starts at
        subrow ``lut_member_base[i]``."""
        from monte_carlo_localization_tpu_torch.mapping.range_lut import lut_dtype
        from monte_carlo_localization_tpu_torch.mapping.range_lut_device import (
            FAR_ROW_MARGIN,
            compact_row_map,
        )
        from monte_carlo_localization_tpu_torch.native import (
            native_build_compact_range_lut,
        )

        self._check_member_geometry(
            "with_member_compact_luts", t_bins, row_stride, subrow_entries
        )
        if (
            self.range_lut is not None
            and self.lut_row_map_base is not None
            and self.lut_theta_bins == t_bins
            and self.row_stride == row_stride
        ):
            return self
        occupied = self.occupied.cpu().numpy()
        dims = self._member_dims_np()
        dtype = lut_dtype(self.max_range_px)
        spe = row_stride // subrow_entries
        m = self.num_maps
        blocks, rmaps = [], []
        bases, rmap_bases = np.zeros(m, np.int64), np.zeros(m, np.int64)
        at = rat = 0
        for i, (h, w) in enumerate(dims.tolist()):
            occ_i = occupied[i, :h, :w]
            clearance = clearance_field(occ_i, self.max_range_px + FAR_ROW_MARGIN + 2)
            row_map_i, cells_i = compact_row_map(clearance, self.max_range_px)
            bases[i], rmap_bases[i] = at, rat
            at += (len(cells_i) + 1) * spe
            rat += h * w
            lut_i = native_build_compact_range_lut(
                occ_i, t_bins, self.max_range_px, row_map_i, row_stride, dtype=dtype
            )
            if lut_i is None:
                raise RuntimeError(
                    "compact per-map LUTs need the native builder (g++ with "
                    "OpenMP), which is unavailable"
                )
            blocks.append(lut_i.reshape(-1))
            rmaps.append(row_map_i)
        if at > np.iinfo(np.int32).max or rat > np.iinfo(np.int32).max:
            raise ValueError("compact fleet LUT index overflows int32; use fewer or smaller maps")
        return dataclasses.replace(
            self,
            range_lut=_upload(np.concatenate(blocks), self.device),
            lut_row_map=_upload(np.concatenate(rmaps), self.device, np.int32),
            lut_theta_bins=t_bins,
            lut_row_stride=row_stride if row_stride != t_bins else 0,
            lut_member_base=_upload(bases, self.device, np.int32),
            lut_row_map_base=_upload(rmap_bases, self.device, np.int32),
        )

    def with_kernel_lut(self, t_bins: int, row_stride: int, itemsize: int) -> "GridMap":
        """Attach the LUT the fused likelihood reads: dense when it fits
        ``MCL_LUT_DENSE_MAX`` bytes (default 2 GiB), row-compacted beyond
        (the JAX filter's choice, ``filter/core.py:238-290``). A batched
        map takes tight per-map blocks, its dense bytes summed over the
        true map areas."""
        from monte_carlo_localization_tpu_torch.ops.lut_query import entries_per_subrow

        if self.is_batched:
            dims = self._member_dims_np()
            dense_bytes = int((dims[:, 0] * dims[:, 1]).sum()) * row_stride * itemsize
        else:
            dense_bytes = self.height * self.width * row_stride * itemsize
        max_dense = int(os.environ.get("MCL_LUT_DENSE_MAX", LUT_DENSE_MAX_DEFAULT))
        if self.is_batched:
            eps = entries_per_subrow(itemsize)
            if dense_bytes > max_dense:
                return self.with_member_compact_luts(t_bins, row_stride, eps)
            return self.with_member_luts(t_bins, row_stride, eps)
        if dense_bytes > max_dense:
            return self.with_compact_range_lut(t_bins, row_stride)
        return self.with_range_lut(t_bins, row_stride=row_stride)


def _per_map(value, batched: bool, device) -> float | torch.Tensor:
    """An origin as the float32 value the JAX map keeps: a Python float,
    or an (M,) float32 tensor on a batched map."""
    if batched:
        return _upload(np.asarray(value, np.float32).reshape(-1), device)
    return float(np.float32(value))


def _optional_int32(value, device) -> torch.Tensor | None:
    return None if value is None else _upload(value, device, np.int32)


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
    device: torch.device | str = DEFAULT_DEVICE,
) -> GridMap:
    """A GridMap on ``device`` from a raw int8 occupancy array."""
    device = resolve_device(device)
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
    device: torch.device | str = DEFAULT_DEVICE,
) -> GridMap:
    """Load a ROS-style map YAML + image pair (image, resolution, origin
    [x, y, yaw], negate, occupied_thresh, free_thresh) onto ``device``."""
    device = resolve_device(device)
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
