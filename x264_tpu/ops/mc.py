"""Motion compensation: half-pel filtering, quarter-pel block fetch, chroma
bilinear MC, pixel averaging.

Reference op table: common/mc.h:267-345 (x264_mc_functions_t); C impls
common/mc.c. Spec math: H.264 8.4.2.2 (6-tap (1,-5,20,20,-5,1) halves,
rounded-average quarters; chroma 1/8-pel bilinear).

Design: the reference frame is border-extended once (PAD px) and its 3
half-pel planes are produced in one fused pass per frame; any block at any
quarter-pel MV is then a batched gather (+ one average), so motion search
candidates across all MBs evaluate as single tensor ops.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

PAD = 32          # border extension (reference frame.c:59 padded strides)
CPAD = 32         # chroma border (covers the chroma MC warp windows)

# qpel index (my&3)*4 + (mx&3) -> source hpel planes (0=full,1=H,2=V,3=C)
HPEL_REF0 = np.array([0, 1, 1, 1, 0, 1, 1, 1, 2, 3, 3, 3, 0, 1, 1, 1])
HPEL_REF1 = np.array([0, 0, 0, 0, 2, 2, 3, 2, 2, 2, 3, 2, 2, 2, 3, 2])


def pad_plane(plane, pad: int = PAD):
    """Edge-replicate border extension (reference expand_border)."""
    return jnp.pad(plane, ((pad, pad), (pad, pad)), mode="edge")


def _tap6_rows(a, dtype=None):
    """(1,-5,20,20,-5,1) along axis 0; output rows = rows - 5. Row slices
    only (no transposes)."""
    n = a.shape[0] - 5
    sl = [a[i:n + i] for i in range(6)]
    if dtype is not None:
        sl = [s.astype(dtype) for s in sl]
    return sl[0] - 5 * sl[1] + 20 * sl[2] + 20 * sl[3] - 5 * sl[4] + sl[5]


def _tap6_cols(a, dtype=None):
    n = a.shape[1] - 5
    sl = [a[:, i:n + i] for i in range(6)]
    if dtype is not None:
        sl = [s.astype(dtype) for s in sl]
    return sl[0] - 5 * sl[1] + 20 * sl[2] + 20 * sl[3] - 5 * sl[4] + sl[5]


def _edge_pad(a, axis, lo, hi):
    """Edge-replicate pad via concatenated broadcast slices."""
    if axis == 0:
        top = jnp.broadcast_to(a[:1], (lo,) + a.shape[1:])
        bot = jnp.broadcast_to(a[-1:], (hi,) + a.shape[1:])
        return jnp.concatenate([top, a, bot], axis=0)
    left = jnp.broadcast_to(a[:, :1], (a.shape[0], lo))
    right = jnp.broadcast_to(a[:, -1:], (a.shape[0], hi))
    return jnp.concatenate([left, a, right], axis=1)


@jax.jit
def hpel_planes(padded):
    """From a padded full-pel plane make (full, H, V, C) uint8 planes of the
    same shape (reference hpel_filter, mc.c). H[x] sits between x,x+1;
    V[y] between y,y+1; C between both.

    int16 for the one-pass H/V taps (|unrounded| <= 255*52 fits), int32
    only for the two-pass C plane — halves HBM traffic vs int32."""
    f = padded
    # horizontal 6-tap at every x (replicated edges)
    fx = _edge_pad(f, 1, 2, 3)
    b1 = _tap6_cols(fx, jnp.int16)            # [H, W] unrounded
    # the rounding shift runs in int32 (exact on every backend)
    hplane = jnp.clip((b1.astype(jnp.int32) + 16) >> 5, 0, 255)
    fy = _edge_pad(f, 0, 2, 3)
    h1 = _tap6_rows(fy, jnp.int16)
    vplane = jnp.clip((h1.astype(jnp.int32) + 16) >> 5, 0, 255)
    # C: vertical 6-tap on unrounded b1 (int32: range ~ +-557k)
    b1y = _edge_pad(b1, 0, 2, 3)
    j1 = _tap6_rows(b1y, jnp.int32)
    cplane = jnp.clip((j1 + 512) >> 10, 0, 255)
    return jnp.stack([f.astype(jnp.uint8), hplane.astype(jnp.uint8),
                      vplane.astype(jnp.uint8), cplane.astype(jnp.uint8)])


def luma_mc_block(hpel, x0, y0, mv, bs: int = 16):
    """Fetch [N, bs, bs] prediction blocks at quarter-pel MVs.

    hpel: [4, Hp, Wp] planes (padded by PAD). x0,y0 [N]: block origin in
    unpadded coords. mv [N,2] quarter-pel (mvx, mvy).
    """
    mvx, mvy = mv[..., 0], mv[..., 1]
    fx = mvx & 3
    fy = mvy & 3
    q = fy * 4 + fx
    ix = x0 + (mvx >> 2) + PAD
    iy = y0 + (mvy >> 2) + PAD
    p0 = jnp.asarray(HPEL_REF0)[q]
    p1 = jnp.asarray(HPEL_REF1)[q]
    ar = jnp.arange(bs, dtype=jnp.int32)
    rows0 = iy[:, None, None] + (fy == 3)[:, None, None] * 0 + \
        ar[None, :, None]
    # ref0 gets +1 row when fy==3; ref1 gets +1 col when fx==3
    rows_a = iy[:, None, None] + (fy == 3).astype(jnp.int32)[:, None, None] \
        + ar[None, :, None]
    cols_a = ix[:, None, None] + ar[None, None, :]
    rows_b = iy[:, None, None] + ar[None, :, None]
    cols_b = ix[:, None, None] + (fx == 3).astype(jnp.int32)[:, None, None] \
        + ar[None, None, :]
    Hp, Wp = hpel.shape[1], hpel.shape[2]
    rows_a = jnp.clip(rows_a, 0, Hp - 1)
    cols_a = jnp.clip(cols_a, 0, Wp - 1)
    rows_b = jnp.clip(rows_b, 0, Hp - 1)
    cols_b = jnp.clip(cols_b, 0, Wp - 1)
    s0 = hpel[p0[:, None, None], rows_a, cols_a].astype(jnp.int32)
    need_avg = (q & 5) != 0
    s1 = hpel[p1[:, None, None], rows_b, cols_b].astype(jnp.int32)
    avg = (s0 + s1 + 1) >> 1
    return jnp.where(need_avg[:, None, None], avg, s0)


def chroma_mc_block(cpad, x0, y0, mv, bs: int = 8):
    """Chroma 1/8-pel bilinear MC (spec 8.4.2.2.2).

    cpad: padded chroma plane [Hp, Wp] (PAD//2 border). x0,y0 [N] unpadded
    chroma coords; mv [N,2] luma quarter-pel (chroma eighth-pel = same
    value against half-res plane)."""
    pad = PAD // 2
    mvx, mvy = mv[..., 0], mv[..., 1]
    dx = mvx & 7
    dy = mvy & 7
    ix = x0 + (mvx >> 3) + pad
    iy = y0 + (mvy >> 3) + pad
    ar = jnp.arange(bs, dtype=jnp.int32)
    rows = iy[:, None, None] + ar[None, :, None]
    cols = ix[:, None, None] + ar[None, None, :]
    Hp, Wp = cpad.shape
    r0 = jnp.clip(rows, 0, Hp - 1)
    c0 = jnp.clip(cols, 0, Wp - 1)
    r1 = jnp.clip(rows + 1, 0, Hp - 1)
    c1 = jnp.clip(cols + 1, 0, Wp - 1)
    A = cpad[r0, c0].astype(jnp.int32)
    B = cpad[r0, c1].astype(jnp.int32)
    C = cpad[r1, c0].astype(jnp.int32)
    D = cpad[r1, c1].astype(jnp.int32)
    dx = dx[:, None, None]
    dy = dy[:, None, None]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
            + (8 - dx) * dy * C + dx * dy * D + 32) >> 6


def fullpel_block(padded, x0, y0, mv_fp, bs: int = 16):
    """Gather [N,bs,bs] full-pel blocks (for integer ME). mv_fp in pels."""
    ix = x0 + mv_fp[..., 0] + PAD
    iy = y0 + mv_fp[..., 1] + PAD
    ar = jnp.arange(bs, dtype=jnp.int32)
    rows = jnp.clip(iy[:, None, None] + ar[None, :, None], 0,
                    padded.shape[0] - 1)
    cols = jnp.clip(ix[:, None, None] + ar[None, None, :], 0,
                    padded.shape[1] - 1)
    return padded[rows, cols].astype(jnp.int32)


# ----------------------------------------------------- numpy spec reference
def hpel_planes_np(padded):
    f = np.asarray(padded, np.int64)

    def tap6(a, axis):
        sl = [np.moveaxis(a, axis, 0)[i:a.shape[axis] - 5 + i]
              for i in range(6)]
        return np.moveaxis(sl[0] - 5 * sl[1] + 20 * sl[2] + 20 * sl[3]
                           - 5 * sl[4] + sl[5], 0, axis)

    fx = np.pad(f, ((0, 0), (2, 3)), mode="edge")
    b1 = tap6(fx, 1)
    hpl = np.clip((b1 + 16) >> 5, 0, 255)
    fy = np.pad(f, ((2, 3), (0, 0)), mode="edge")
    h1 = tap6(fy, 0)
    vpl = np.clip((h1 + 16) >> 5, 0, 255)
    b1y = np.pad(b1, ((2, 3), (0, 0)), mode="edge")
    j1 = tap6(b1y, 0)
    cpl = np.clip((j1 + 512) >> 10, 0, 255)
    return np.stack([f, hpl, vpl, cpl]).astype(np.uint8)
