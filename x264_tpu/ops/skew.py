"""Skewed (wavefront-aligned) frame layout.

The per-MB raster dependencies (left / top / top-left — reference
slice_write order, encoder.c:2752) make the MB wavefront the minimal
sequential structure for exact intra reconstruction and in-loop deblocking
(SURVEY.md §2.9.4). A naive scan gathers each diagonal's MBs with computed
indices.

This module removes every gather: planes are stored SKEWED so that
wavefront diagonal d is a contiguous vertical strip. MB(x, y) of an s-px
plane lives at rows [y*s, y*s+s), cols [(x + y + pad_strips)*s, ...+s).
Each scan step is then a static-shaped jax.lax.dynamic_slice /
dynamic_update_slice.

Neighbor algebra in skewed space (d = x + y):
  left  MB (x-1, y):   strip d-1, same lane y
  top   MB (x, y-1):   strip d-1, lane y-1
  topleft  (x-1, y-1): strip d-2, lane y-1
"""

from __future__ import annotations

import jax.numpy as jnp


def n_diags(mbw: int, mbh: int) -> int:
    return mbw + mbh - 1


def skew_plane(plane, s: int, pad_strips: int = 1):
    """[H, W] -> [H, (D + pad_strips) * s] zero-filled skewed plane."""
    H, W = plane.shape
    mbh, mbw = H // s, W // s
    D = n_diags(mbw, mbh)
    Ws = (D + pad_strips) * s
    bands = []
    for y in range(mbh):
        left = (y + pad_strips) * s
        bands.append(jnp.pad(plane[y * s:(y + 1) * s],
                             ((0, 0), (left, Ws - left - W))))
    return jnp.concatenate(bands, axis=0)


def unskew_plane(skewed, s: int, mbw: int, pad_strips: int = 1):
    """Inverse of skew_plane. skewed [H, (D+pad)*s] -> [H, mbw*s]."""
    H = skewed.shape[0]
    mbh = H // s
    W = mbw * s
    bands = [skewed[y * s:(y + 1) * s,
                    (y + pad_strips) * s:(y + pad_strips) * s + W]
             for y in range(mbh)]
    return jnp.concatenate(bands, axis=0)


def skew_mb(arr, pad_strips: int = 1, fill=0):
    """MB-grid array [mbh, mbw, ...] -> [mbh, D + pad_strips, ...].

    Strip d sits at index d + pad_strips - ... : MB(x, y) lands at column
    (x + y + pad_strips) - wait, at column index x + y + pad_strips in the
    output; invalid cells hold `fill`."""
    mbh, mbw = arr.shape[:2]
    D = n_diags(mbw, mbh)
    S = D + pad_strips
    rows = []
    for y in range(mbh):
        cfg = [(y + pad_strips, S - mbw - y - pad_strips)] \
            + [(0, 0)] * (arr.ndim - 2)
        rows.append(jnp.pad(arr[y], cfg, constant_values=fill))
    return jnp.stack(rows)


def unskew_mb(arr, mbw: int, pad_strips: int = 1):
    """[mbh or D-major stack...] inverse of skew_mb for [mbh, S, ...]."""
    mbh = arr.shape[0]
    rows = [arr[y, y + pad_strips: y + pad_strips + mbw] for y in range(mbh)]
    return jnp.stack(rows)


def unskew_scan_outputs(stacked, mbw: int):
    """Scan-stacked per-diagonal outputs [D, mbh, ...] -> raster [mbh*mbw, ...].

    Diagonal d, lane y holds MB(x=d-y, y); raster band y is the slice
    stacked[y : y+mbw, y]."""
    mbh = stacked.shape[1]
    rows = [stacked[y:y + mbw, y] for y in range(mbh)]
    return jnp.concatenate(rows, axis=0)
