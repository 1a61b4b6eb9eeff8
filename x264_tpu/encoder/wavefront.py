"""Wavefront scheduling utilities.

The reference encodes MBs serially in raster order (slice_write,
encoder.c:2752) because intra prediction/MV prediction depend on the left /
top / top-left neighbors. Here we batch all MBs of an anti-diagonal
(d = mbx + mby): every dependency of diagonal d lives on d-1 / d-2, so a
lax.scan over diagonals with a vmapped step gives min(mb_w, mb_h)-way
parallelism with exact (conformant) reconstruction. (SURVEY.md §2.9.4/§5.7.)
"""

from __future__ import annotations

import numpy as np


def schedule(mb_w: int, mb_h: int):
    """Build the static wavefront schedule.

    Returns (mbx [D, L], mby [D, L], valid [D, L], lane_of_mb [N]):
    D = mb_w+mb_h-1 diagonals, L = min lanes; lane_of_mb maps raster MB index
    -> (diag, lane) for reordering scan outputs back to raster order.
    """
    depth = mb_w + mb_h - 1
    lanes = min(mb_w, mb_h)
    mbx = np.zeros((depth, lanes), dtype=np.int32)
    mby = np.zeros((depth, lanes), dtype=np.int32)
    valid = np.zeros((depth, lanes), dtype=bool)
    diag_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    lane_of = np.zeros(mb_w * mb_h, dtype=np.int32)
    for d in range(depth):
        y0 = max(0, d - mb_w + 1)
        y1 = min(d, mb_h - 1)
        for lane, y in enumerate(range(y0, y1 + 1)):
            x = d - y
            mbx[d, lane] = x
            mby[d, lane] = y
            valid[d, lane] = True
            n = y * mb_w + x
            diag_of[n] = d
            lane_of[n] = lane
    return mbx, mby, valid, diag_of, lane_of


def gather_raster(stacked: np.ndarray, diag_of: np.ndarray,
                  lane_of: np.ndarray) -> np.ndarray:
    """Reorder scan output [D, L, ...] to raster MB order [N, ...]."""
    return np.asarray(stacked)[diag_of, lane_of]
