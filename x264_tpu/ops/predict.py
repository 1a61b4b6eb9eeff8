"""Intra prediction: all H.264 modes, batched.

Reference op table: common/predict.h:30-110; C impls common/predict.c.
Design: a block's prediction is a pure function of its (substituted)
edge pixels, so every mode for every block in a wavefront batch is computed
as gathers over precomputed filtered edge arrays:

    e  = [left[n-1..0], topleft, top[0..2n-1], dup]   (edge vector)
    f3 = 3-tap (1,2,1) filtered e
    h2 = 2-tap (1,1) filtered e

then each directional mode is a constant-index gather into e/f3/h2.

`*_np` twins implement the spec formulas (8.3.1-8.3.3) directly with loops —
deliberately different code for checkasm-style cross-validation.

Mode numbering per spec: I4x4/I8x8: 0=V 1=H 2=DC 3=DDL 4=DDR 5=VR 6=HD 7=VL
8=HU; I16x16: 0=V 1=H 2=DC 3=P; chroma: 0=DC 1=H 2=V 3=P.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

I_PRED_4x4_V, I_PRED_4x4_H, I_PRED_4x4_DC, I_PRED_4x4_DDL, \
    I_PRED_4x4_DDR, I_PRED_4x4_VR, I_PRED_4x4_HD, I_PRED_4x4_VL, \
    I_PRED_4x4_HU = range(9)
I_PRED_16x16_V, I_PRED_16x16_H, I_PRED_16x16_DC, I_PRED_16x16_P = range(4)
I_PRED_CHROMA_DC, I_PRED_CHROMA_H, I_PRED_CHROMA_V, I_PRED_CHROMA_P = range(4)


# =========================================================== 4x4 (9 modes)
def _edge_vec4(left, top, tl):
    """e[13+1]: [l3,l2,l1,l0,Z,t0..t7,t7dup]. left [...,4], top [...,8]."""
    lrev = left[..., ::-1]
    e = jnp.concatenate(
        [lrev, tl[..., None], top, top[..., 7:8]], axis=-1)
    return e.astype(jnp.int32)


def _filters(e):
    """f3[i] = (e[i-1]+2e[i]+e[i+1]+2)>>2 valid for i in 1..n-2;
    h2[i] = (e[i]+e[i+1]+1)>>1 valid for i in 0..n-2. Padded to len(e)."""
    f3 = jnp.zeros_like(e)
    f3 = f3.at[..., 1:-1].set(
        (e[..., :-2] + 2 * e[..., 1:-1] + e[..., 2:] + 2) >> 2)
    h2 = jnp.zeros_like(e)
    h2 = h2.at[..., :-1].set((e[..., :-1] + e[..., 1:] + 1) >> 1)
    return f3, h2


def _dir_mode_indices4():
    """Static gather plans for the 7 directional 4x4 modes.

    Returns dict mode -> (source, idx[4,4]) where source in {'e','f','h'}
    plus fixup wheres handled in predict_4x4_all."""
    x = np.arange(4)[None, :]
    y = np.arange(4)[:, None]
    plans = {}
    plans[I_PRED_4x4_V] = ("e", np.broadcast_to(5 + x, (4, 4)))
    plans[I_PRED_4x4_H] = ("e", np.broadcast_to(3 - y, (4, 4)))
    plans[I_PRED_4x4_DDL] = ("f", 6 + x + y)
    plans[I_PRED_4x4_DDR] = ("f", 4 + x - y)
    # VR: even zVR -> h[4+x-(y>>1)], odd -> f[4+x-(y>>1)], zVR==-3 -> f[2]
    zvr = 2 * x - y
    idx = 4 + x - (y >> 1)
    plans[I_PRED_4x4_VR] = ("vr", (zvr, idx))
    # HD: zHD=2y-x; even -> h[3-(y-(x>>1))], odd -> f[4-y+(x>>1)],
    # zHD<-1 -> f[3+x]
    zhd = 2 * y - x
    plans[I_PRED_4x4_HD] = ("hd", (zhd, 3 - (y - (x >> 1)), 4 - y + (x >> 1),
                                   3 + x))
    # VL: even y -> h[5+x+(y>>1)], odd y -> f[6+x+(y>>1)]
    plans[I_PRED_4x4_VL] = ("vl", (5 + x + (y >> 1), 6 + x + (y >> 1)))
    # HU: zHU=x+2y; even -> h[2-y-(x>>1)], odd<5 -> f[2-y-(x>>1)],
    # ==5 -> (l2+3l3+2)>>2, >5 -> l3 (=e[0])
    zhu = x + 2 * y
    plans[I_PRED_4x4_HU] = ("hu", (zhu, 2 - y - (x >> 1)))
    return plans


_PLANS4 = _dir_mode_indices4()


def _gather(arr, idx):
    """Gather last axis by a static [4,4] (or [8,8]) index grid."""
    flat = idx.reshape(-1)
    g = arr[..., jnp.asarray(flat)]
    return g.reshape(arr.shape[:-1] + idx.shape)


@jax.jit
def predict_4x4_all(left, top, tl, avail_left, avail_top):
    """All 9 modes for a batch of 4x4 blocks.

    left [...,4], top [...,8] (cols 4..7 = top-right, caller substitutes
    t[3] when unavailable), tl [...]; avail_* bool [...].
    Returns [..., 9, 4, 4] int32. Invalid modes produce *some* prediction;
    caller masks them out of selection.
    """
    e = _edge_vec4(left, top, tl)
    f3, h2 = _filters(e)
    outs = []
    # V, H
    outs.append(_gather(e, _PLANS4[I_PRED_4x4_V][1]))
    outs.append(_gather(e, _PLANS4[I_PRED_4x4_H][1]))
    # DC with availability variants
    sum_t = jnp.sum(e[..., 5:9], axis=-1)
    sum_l = jnp.sum(e[..., 0:4], axis=-1)
    both = (sum_t + sum_l + 4) >> 3
    only_t = (sum_t + 2) >> 2
    only_l = (sum_l + 2) >> 2
    at = avail_top
    al = avail_left
    dcv = jnp.where(at & al, both,
                    jnp.where(at, only_t,
                              jnp.where(al, only_l, 128)))
    outs.append(jnp.broadcast_to(dcv[..., None, None],
                                 dcv.shape + (4, 4)).astype(jnp.int32))
    # DDL, DDR
    outs.append(_gather(f3, _PLANS4[I_PRED_4x4_DDL][1]))
    outs.append(_gather(f3, _PLANS4[I_PRED_4x4_DDR][1]))
    # VR
    zvr, idx = _PLANS4[I_PRED_4x4_VR][1]
    vr = jnp.where(jnp.asarray((zvr % 2 == 0) & (zvr >= 0)),
                   _gather(h2, idx), _gather(f3, idx))
    vr = jnp.where(jnp.asarray(zvr == -3),
                   f3[..., 2:3, None], vr)
    outs.append(vr)
    # HD
    zhd, ih, if_, itop = _PLANS4[I_PRED_4x4_HD][1]
    hd = jnp.where(jnp.asarray(zhd % 2 == 0),
                   _gather(h2, np.maximum(ih, 0)),
                   _gather(f3, np.maximum(if_, 1)))
    hd = jnp.where(jnp.asarray(zhd < -1), _gather(f3, itop), hd)
    outs.append(hd)
    # VL
    ihh, iff = _PLANS4[I_PRED_4x4_VL][1]
    yy = np.arange(4)[:, None]
    vl = jnp.where(jnp.asarray(np.broadcast_to(yy % 2 == 0, (4, 4))),
                   _gather(h2, ihh), _gather(f3, iff))
    outs.append(vl)
    # HU
    zhu, ilow = _PLANS4[I_PRED_4x4_HU][1]
    l2, l3 = e[..., 1], e[..., 0]
    hu_55 = ((l2 + 3 * l3 + 2) >> 2)[..., None, None]
    hu = jnp.where(jnp.asarray(zhu % 2 == 0),
                   _gather(h2, np.maximum(ilow, 0)),
                   _gather(f3, np.maximum(ilow, 1)))
    hu = jnp.where(jnp.asarray(zhu == 5), hu_55, hu)
    hu = jnp.where(jnp.asarray(zhu > 5), l3[..., None, None], hu)
    outs.append(hu)
    return jnp.stack(outs, axis=-3)


def predict_4x4_mode_valid(avail_left, avail_top, avail_tl):
    """[..., 9] bool: which modes may legally be signalled."""
    al, at, atl = [jnp.asarray(a) for a in (avail_left, avail_top, avail_tl)]
    return jnp.stack([
        at,                # V
        al,                # H
        jnp.ones_like(at),  # DC
        at,                # DDL (top-right substituted from top)
        al & at & atl,     # DDR
        al & at & atl,     # VR
        al & at & atl,     # HD
        at,                # VL
        al,                # HU
    ], axis=-1)


# ========================================================== 16x16 (4 modes)
@jax.jit
def predict_16x16_all(left, top, tl, avail_left, avail_top):
    """left [...,16], top [...,16], tl [...]. Returns [..., 4, 16, 16]."""
    left = left.astype(jnp.int32)
    top = top.astype(jnp.int32)
    tl = tl.astype(jnp.int32)
    n = 16
    v = jnp.broadcast_to(top[..., None, :], top.shape[:-1] + (n, n))
    h = jnp.broadcast_to(left[..., :, None], left.shape[:-1] + (n, n))
    sum_t = jnp.sum(top, axis=-1)
    sum_l = jnp.sum(left, axis=-1)
    dcv = jnp.where(avail_top & avail_left, (sum_t + sum_l + 16) >> 5,
                    jnp.where(avail_top, (sum_t + 8) >> 4,
                              jnp.where(avail_left, (sum_l + 8) >> 4, 128)))
    dc = jnp.broadcast_to(dcv[..., None, None], dcv.shape + (n, n))
    # plane (spec 8.3.3.4)
    xm = jnp.arange(8, dtype=jnp.int32) + 1                      # 1..8
    hgrad = jnp.sum(xm * (top[..., 8:16] -
                          jnp.concatenate([tl[..., None],
                                           top[..., :7]], axis=-1)[..., ::-1]),
                    axis=-1)
    vgrad = jnp.sum(xm * (left[..., 8:16] -
                          jnp.concatenate([tl[..., None],
                                           left[..., :7]], axis=-1)[..., ::-1]),
                    axis=-1)
    a = 16 * (left[..., 15] + top[..., 15])
    b = (5 * hgrad + 32) >> 6
    c = (5 * vgrad + 32) >> 6
    xx = jnp.arange(n, dtype=jnp.int32)[None, :] - 7
    yy = jnp.arange(n, dtype=jnp.int32)[:, None] - 7
    plane = (a[..., None, None] + b[..., None, None] * xx
             + c[..., None, None] * yy + 16) >> 5
    plane = jnp.clip(plane, 0, 255)
    return jnp.stack([v, h, dc, plane], axis=-3)


def predict_16x16_mode_valid(avail_left, avail_top, avail_tl):
    al, at, atl = [jnp.asarray(a) for a in (avail_left, avail_top, avail_tl)]
    return jnp.stack([at, al, jnp.ones_like(at), al & at & atl], axis=-1)


# ===================================================== chroma NxN (4 modes)
@partial(jax.jit, static_argnames=("size",))
def predict_chroma_all(left, top, tl, avail_left, avail_top, size: int = 8):
    """Chroma prediction, size=8 (4:2:0). Returns [..., 4, s, s]
    in chroma mode order DC,H,V,P."""
    s = size
    left = left.astype(jnp.int32)
    top = top.astype(jnp.int32)
    tl = tl.astype(jnp.int32)
    h = jnp.broadcast_to(left[..., :, None], left.shape[:-1] + (s, s))
    v = jnp.broadcast_to(top[..., None, :], top.shape[:-1] + (s, s))
    # DC: per 4x4 quadrant (spec 8.3.4.1): corner quadrants use their own
    # adjacent edges; top-right quadrant prefers top, bottom-left prefers left
    halves_t = [jnp.sum(top[..., :4], axis=-1), jnp.sum(top[..., 4:8], axis=-1)]
    halves_l = [jnp.sum(left[..., :4], axis=-1),
                jnp.sum(left[..., 4:8], axis=-1)]
    at, al = avail_top, avail_left

    def dc_q(st, sl, prefer):
        both = (st + sl + 4) >> 3
        t_only = (st + 2) >> 2
        l_only = (sl + 2) >> 2
        if prefer == "both":
            return jnp.where(at & al, both,
                             jnp.where(at, t_only,
                                       jnp.where(al, l_only, 128)))
        if prefer == "top":
            return jnp.where(at, t_only, jnp.where(al, l_only, 128))
        return jnp.where(al, l_only, jnp.where(at, t_only, 128))

    q00 = dc_q(halves_t[0], halves_l[0], "both")
    q01 = dc_q(halves_t[1], halves_l[0], "top")
    q10 = dc_q(halves_t[0], halves_l[1], "left")
    q11 = dc_q(halves_t[1], halves_l[1], "both")
    qrow0 = jnp.stack([q00, q01], axis=-1)
    qrow1 = jnp.stack([q10, q11], axis=-1)
    qs = jnp.stack([qrow0, qrow1], axis=-2)           # [...,2,2]
    dc = jnp.repeat(jnp.repeat(qs, 4, axis=-2), 4, axis=-1)
    # plane (spec 8.3.4.4, 4:2:0 8x8)
    xm = jnp.arange(4, dtype=jnp.int32) + 1
    hgrad = jnp.sum(xm * (top[..., 4:8] -
                          jnp.concatenate([tl[..., None], top[..., :3]],
                                          axis=-1)[..., ::-1]), axis=-1)
    vgrad = jnp.sum(xm * (left[..., 4:8] -
                          jnp.concatenate([tl[..., None], left[..., :3]],
                                          axis=-1)[..., ::-1]), axis=-1)
    a = 16 * (left[..., 7] + top[..., 7])
    b = (17 * hgrad + 16) >> 5
    c = (17 * vgrad + 16) >> 5
    xx = jnp.arange(s, dtype=jnp.int32)[None, :] - 3
    yy = jnp.arange(s, dtype=jnp.int32)[:, None] - 3
    plane = (a[..., None, None] + b[..., None, None] * xx
             + c[..., None, None] * yy + 16) >> 5
    plane = jnp.clip(plane, 0, 255)
    return jnp.stack([dc, h, v, plane], axis=-3)


def predict_chroma_mode_valid(avail_left, avail_top, avail_tl):
    al, at, atl = [jnp.asarray(a) for a in (avail_left, avail_top, avail_tl)]
    return jnp.stack([jnp.ones_like(at), al, at, al & at & atl], axis=-1)


# ============================================== numpy spec reference (slow)
def predict_4x4_np(mode, left, top, tl, avail_left=True, avail_top=True):
    """Direct spec 8.3.1.2 implementation, one block. top has 8 entries
    (4 top + 4 top-right, already substituted)."""
    p = np.full((9, 12), 0, dtype=np.int64)
    t = np.asarray(top, np.int64)
    l = np.asarray(left, np.int64)  # noqa: E741
    z = int(tl)
    pred = np.zeros((4, 4), np.int64)
    if mode == I_PRED_4x4_V:
        pred[:] = t[None, :4]
    elif mode == I_PRED_4x4_H:
        pred[:] = l[:, None]
    elif mode == I_PRED_4x4_DC:
        if avail_left and avail_top:
            pred[:] = (t[:4].sum() + l.sum() + 4) >> 3
        elif avail_top:
            pred[:] = (t[:4].sum() + 2) >> 2
        elif avail_left:
            pred[:] = (l.sum() + 2) >> 2
        else:
            pred[:] = 128
    elif mode == I_PRED_4x4_DDL:
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    pred[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    pred[y, x] = (t[x + y] + 2 * t[x + y + 1]
                                  + t[x + y + 2] + 2) >> 2
    elif mode == I_PRED_4x4_DDR:
        def gp(xx, yy):
            if yy == -1:
                return z if xx == -1 else t[xx]
            return l[yy]
        for y in range(4):
            for x in range(4):
                if x > y:
                    pred[y, x] = (gp(x - y - 2, -1) + 2 * gp(x - y - 1, -1)
                                  + gp(x - y, -1) + 2) >> 2
                elif x < y:
                    pred[y, x] = (gp(-1, y - x - 2) + 2 * gp(-1, y - x - 1)
                                  + gp(-1, y - x) + 2) >> 2
                else:
                    pred[y, x] = (t[0] + 2 * z + l[0] + 2) >> 2
    elif mode == I_PRED_4x4_VR:
        def gt(i):
            return z if i == -1 else t[i]

        def gl(i):
            return z if i == -1 else l[i]
        for y in range(4):
            for x in range(4):
                zvr = 2 * x - y
                if zvr >= 0 and zvr % 2 == 0:
                    pred[y, x] = (gt(x - (y >> 1) - 1) + gt(x - (y >> 1))
                                  + 1) >> 1
                elif zvr >= 0:
                    pred[y, x] = (gt(x - (y >> 1) - 2)
                                  + 2 * gt(x - (y >> 1) - 1)
                                  + gt(x - (y >> 1)) + 2) >> 2
                elif zvr == -1:
                    pred[y, x] = (l[0] + 2 * z + t[0] + 2) >> 2
                else:
                    pred[y, x] = (gl(y - 1) + 2 * gl(y - 2)
                                  + gl(y - 3) + 2) >> 2
    elif mode == I_PRED_4x4_HD:
        def gl(i):
            return z if i == -1 else l[i]

        def gt2(i):
            return z if i == -1 else t[i]
        for y in range(4):
            for x in range(4):
                zhd = 2 * y - x
                if zhd >= 0 and zhd % 2 == 0:
                    pred[y, x] = (gl(y - (x >> 1) - 1) + gl(y - (x >> 1))
                                  + 1) >> 1
                elif zhd >= 0:
                    pred[y, x] = (gl(y - (x >> 1) - 2)
                                  + 2 * gl(y - (x >> 1) - 1)
                                  + gl(y - (x >> 1)) + 2) >> 2
                elif zhd == -1:
                    pred[y, x] = (t[0] + 2 * z + l[0] + 2) >> 2
                else:
                    pred[y, x] = (gt2(x - 1) + 2 * gt2(x - 2)
                                  + gt2(x - 3) + 2) >> 2
    elif mode == I_PRED_4x4_VL:
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    pred[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1]
                                  + 1) >> 1
                else:
                    pred[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                                  + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == I_PRED_4x4_HU:
        for y in range(4):
            for x in range(4):
                zhu = x + 2 * y
                if zhu > 5:
                    pred[y, x] = l[3]
                elif zhu == 5:
                    pred[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                elif zhu % 2 == 0:
                    pred[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1]
                                  + 1) >> 1
                else:
                    pred[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                                  + l[y + (x >> 1) + 2] + 2) >> 2
    return pred.astype(np.int32)


def predict_16x16_plane_np(left, top, tl):
    l = np.asarray(left, np.int64)  # noqa: E741
    t = np.asarray(top, np.int64)
    z = int(tl)
    tp = np.concatenate([[z], t])     # tp[i] = p[i-1, -1]
    lp = np.concatenate([[z], l])
    hh = sum((x + 1) * (tp[9 + x] - tp[7 - x]) for x in range(8))
    vv = sum((y + 1) * (lp[9 + y] - lp[7 - y]) for y in range(8))
    a = 16 * (l[15] + t[15])
    b = (5 * hh + 32) >> 6
    c = (5 * vv + 32) >> 6
    pred = np.zeros((16, 16), np.int64)
    for y in range(16):
        for x in range(16):
            pred[y, x] = np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5,
                                 0, 255)
    return pred.astype(np.int32)


def predict_chroma_plane_np(left, top, tl):
    l = np.asarray(left, np.int64)  # noqa: E741
    t = np.asarray(top, np.int64)
    z = int(tl)
    tp = np.concatenate([[z], t])
    lp = np.concatenate([[z], l])
    hh = sum((x + 1) * (tp[5 + x] - tp[3 - x]) for x in range(4))
    vv = sum((y + 1) * (lp[5 + y] - lp[3 - y]) for y in range(4))
    a = 16 * (l[7] + t[7])
    b = (17 * hh + 16) >> 5
    c = (17 * vv + 16) >> 5
    pred = np.zeros((8, 8), np.int64)
    for y in range(8):
        for x in range(8):
            pred[y, x] = np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5,
                                 0, 255)
    return pred.astype(np.int32)
