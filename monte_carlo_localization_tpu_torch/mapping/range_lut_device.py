"""Row compaction of the range LUT for giant maps (Spielberg scale), as in
the JAX package's ``mapping/range_lut_device.py:160-190``.

A cell whose clearance is at least ``max_range_px + FAR_ROW_MARGIN`` sees
max_range in every direction, so all such cells share one constant far
row (row 0). Only cells near an obstacle or the map border get real rows,
addressed through an (H*W,) int32 row map.

The on-device LUT builders of the JAX module are not ported yet: the port
builds the compact LUT on the host (native C++) and uploads it once.
"""

from __future__ import annotations

import numpy as np

# margin over max_range_px for the shared far row: +1 for the reference's
# -1 px DDA bias, +1 for the shear-scan DP's <= 0.5-cell lateral snap
FAR_ROW_MARGIN = 2


def compact_row_map(clearance: np.ndarray, max_range_px: int):
    """(row_map (H*W,) int32, row_cells (K,) int64): row 0 is the shared
    far row; cells with clearance < max_range_px + margin get rows 1..K."""
    near = np.asarray(clearance).reshape(-1) < max_range_px + FAR_ROW_MARGIN
    row_cells = np.nonzero(near)[0]
    row_map = np.zeros(near.shape[0], np.int32)
    row_map[row_cells] = np.arange(1, len(row_cells) + 1, dtype=np.int32)
    return row_map, row_cells
