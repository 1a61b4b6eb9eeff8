"""Intra (I) frame encoding: batched mode decision + wavefront commit.

Reference analogues: mb_analyse_intra (analyse.c:668) for the decision,
x264_macroblock_encode I16x16 path (macroblock.c:126) + chroma
(macroblock.c:259) for the commit, but re-expressed as whole-frame tensor
passes (SURVEY.md §7.1):

  1. DECIDE (one batched pass, no recon deps): per-MB intra mode costs are
     evaluated against *source* neighbors — the two-phase approximation the
     reference itself makes for threads (doc/threads.txt:41).
  2. COMMIT (lax.scan over wavefront diagonals): exact reconstruction with
     true decoded neighbors; produces quantized coefficients + recon planes.
  3. ENTROPY (host, vectorized CAVLC in entropy/cavlc.py).

Round-1 scope: I16x16 luma + 8x8 chroma modes (I4x4/I8x8 land next).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..entropy import nal as nal_mod
from ..entropy.slice_hdr import slice_header_write
from ..ops import dct, pixel, predict, quant
from ..ops.tables import ZIGZAG4_FRAME, chroma_qp
from . import wavefront
from .encoder import TYPE_IDR


def _mb_tiles(plane, s):
    """[H, W] -> [mbh, mbw, s, s]"""
    h, w = plane.shape
    return plane.reshape(h // s, s, w // s, s).swapaxes(1, 2)


# ---------------------------------------------------------------- decision
@jax.jit
def decide_modes_full(y, u, v, lam=None):
    """Batched I16x16 + chroma mode decision from source neighbors.

    lam: optional per-MB (or scalar) lambda; when given, each candidate
    carries its mode-signalling bit cost like the reference
    (analyse.c:730: SATD + lambda*bs_size_ue(mode); analyse.c:632 for
    chroma) so the P/B intra-vs-inter comparison sees real bit biases
    instead of invented constants.

    Returns (i16_mode [mbh, mbw], chroma_mode [mbh, mbw], satd_total,
    luma_cost [mbh, mbw] — per-MB best-mode luma cost, used by the P/B
    intra-vs-inter decision, analyse.c:2939)."""
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16

    def neighbors(plane, s):
        t = _mb_tiles(plane, s)              # [mbh, mbw, s, s]
        # source top rows / left cols shifted from neighbor tiles
        top = jnp.roll(t[:, :, s - 1, :], 1, axis=0)       # [mbh,mbw,s]
        left = jnp.roll(t[:, :, :, s - 1], 1, axis=1)
        tl = jnp.roll(jnp.roll(t[:, :, s - 1, s - 1], 1, 0), 1, 1)
        return t, top, left, tl

    ay = jnp.arange(mbh)[:, None] > 0
    ax = jnp.arange(mbw)[None, :] > 0
    at = jnp.broadcast_to(ay, (mbh, mbw))
    al = jnp.broadcast_to(ax, (mbh, mbw))

    ty, top_y, left_y, tl_y = neighbors(y, 16)
    preds = predict.predict_16x16_all(left_y, top_y, tl_y, al, at)
    costs = pixel.satd(preds, ty[:, :, None])             # [mbh,mbw,4]
    if lam is not None:
        # ue() sizes of spec modes [V,H,DC,Plane] = [1,3,3,5] bits
        ue16 = jnp.asarray(np.array([1, 3, 3, 5], np.int32))
        costs = costs + jnp.asarray(lam)[..., None] * ue16
    valid = predict.predict_16x16_mode_valid(al, at, at & al)
    costs = jnp.where(valid, costs, 1 << 28)
    i16_mode = jnp.argmin(costs, axis=-1).astype(jnp.int32)

    tu, top_u, left_u, tl_u = neighbors(u, 8)
    tv, top_v, left_v, tl_v = neighbors(v, 8)
    pu = predict.predict_chroma_all(left_u, top_u, tl_u, al, at)
    pv = predict.predict_chroma_all(left_v, top_v, tl_v, al, at)
    ccosts = pixel.satd(pu, tu[:, :, None]) + pixel.satd(pv, tv[:, :, None])
    if lam is not None:
        # chroma_pred_mode ue(): spec order [DC,H,V,Plane] -> our stack
        # order matches predict_chroma_all; mode k costs ue(k)
        uec = jnp.asarray(np.array([1, 3, 3, 5], np.int32))
        ccosts = ccosts + jnp.asarray(lam)[..., None] * uec
    cvalid = predict.predict_chroma_mode_valid(al, at, at & al)
    ccosts = jnp.where(cvalid, ccosts, 1 << 28)
    chroma_mode = jnp.argmin(ccosts, axis=-1).astype(jnp.int32)
    satd_cost = (jnp.sum(jnp.min(costs, axis=-1))
                 + jnp.sum(jnp.min(ccosts, axis=-1)))
    return i16_mode, chroma_mode, satd_cost, jnp.min(costs, axis=-1)


def decide_modes(y, u, v):
    """Compat wrapper: (i16_mode, chroma_mode, satd_total)."""
    i16_mode, chroma_mode, satd_cost, _ = decide_modes_full(y, u, v)
    return i16_mode, chroma_mode, satd_cost


# z-scan coding order of 4x4 luma blocks (spec figure 6-10)
I4_ZX = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
I4_ZY = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
# in-MB blocks whose above-right 4x4 neighbor is unavailable per the
# z-scan decoding-order rule (spec 6.4.12.3): raster (bx,by) pairs
_I4_TR_UNAVAIL_INMB = {(1, 1), (3, 1), (3, 2), (1, 3), (3, 3)}


def _i4_block_avail(bx, by):
    """Static availability kind of block (bx,by)'s above-right neighbor:
    'real' (in-MB or above-MB, always decoded), 'lane' (depends on the
    MB's above availability), 'none' (substituted t[3] per 8.3.1.2).
    Block (3,0)'s above-right lives in the above-RIGHT MB which shares
    our 1:1 wavefront diagonal — treated as 'none' and modes DDL/VL are
    banned there (encoder-side choice; substitution never signaled)."""
    if by == 0:
        return "none" if bx == 3 else "lane"
    return "none" if (bx, by) in _I4_TR_UNAVAIL_INMB else "real"


@jax.jit
def decide_modes_i4(y, lam=None):
    """Batched I4x4 mode decision from SOURCE neighbors (the two-phase
    approximation; exact recon happens in the wavefront commit).

    lam: optional per-MB [mbh,mbw] (or scalar) lambda. When given, mode
    selection and the returned cost follow the reference
    (analyse.c:866,173): per-block +3*lambda when the mode is not the
    most-probable mode (MPM approximated from the first-pass neighbor
    winners), plus the lambda*(24+16) I_4x4 base cost. Without lam the
    cost is raw summed SATD (legacy).

    Returns (modes [mbh, mbw, 16] raster-block spec modes,
    cost [mbh, mbw] — compare against I16's)."""
    from ..ops.predict import predict_4x4_all, predict_4x4_mode_valid
    H, W = y.shape
    mbh, mbw = H // 16, W // 16
    H4, W4 = mbh * 4, mbw * 4
    yi = y.astype(jnp.int32)
    pad = jnp.pad(yi, ((1, 0), (1, 4)), mode="edge")  # top row + left col
    blocks = _mb_tiles(y, 4).astype(jnp.int32)        # [H4, W4, 4, 4]
    r4 = jnp.arange(4)
    by4 = jnp.arange(H4)[:, None]
    bx4 = jnp.arange(W4)[None, :]
    top8 = pad[by4[..., None] * 4 + 1 - 1,
               bx4[..., None] * 4 + 1 + jnp.arange(8)[None, None, :]]
    left4 = pad[by4[..., None] * 4 + 1 + r4[None, None, :],
                bx4[..., None] * 4 + 1 - 1]
    tl = pad[by4 * 4, bx4 * 4]
    al = jnp.broadcast_to(bx4 > 0, (H4, W4))
    at = jnp.broadcast_to(by4 > 0, (H4, W4))
    atl = al & at
    # above-right availability per the static in-MB kinds + frame edges
    kind = np.zeros((4, 4), np.int32)     # 0 none, 1 lane(at), 2 real
    for bbx in range(4):
        for bby in range(4):
            k = _i4_block_avail(bbx, bby)
            kind[bby, bbx] = {"none": 0, "lane": 1, "real": 2}[k]
    kind_g = jnp.asarray(np.tile(kind, (mbh, mbw)))
    tr_ok = jnp.where(kind_g == 2, True,
                      jnp.where(kind_g == 1, at, False))
    # spec 8.3.1.2 substitution: unavailable top-right -> t[3]
    sub = jnp.broadcast_to(top8[..., 3:4], top8.shape[:-1] + (4,))
    top8 = jnp.concatenate(
        [top8[..., :4], jnp.where(tr_ok[..., None], top8[..., 4:], sub)],
        axis=-1)
    preds = predict_4x4_all(left4, top8, tl, al, at)   # [H4,W4,9,4,4]
    costs = pixel.satd(preds, blocks[:, :, None])      # [H4,W4,9]
    valid = predict_4x4_mode_valid(al, at, atl)
    # encoder-side ban: block (3,0) of each MB may not use DDL/VL (their
    # real above-right pixels live in the above-right MB, which is on the
    # same wavefront diagonal)
    ban = np.zeros((4, 4, 9), bool)
    ban[0, 3, 3] = ban[0, 3, 7] = True
    valid = valid & ~jnp.asarray(np.tile(ban, (mbh, mbw, 1)))
    costs = jnp.where(valid, costs, 1 << 28)
    if lam is not None:
        lam4 = jnp.broadcast_to(
            jnp.repeat(jnp.repeat(jnp.asarray(lam)
                                  * jnp.ones((mbh, mbw), jnp.int32),
                                  4, axis=0), 4, axis=1), (H4, W4))
        # pass 1: raw winners seed the neighbor modes for the MPM
        modes0 = jnp.argmin(costs, axis=-1).astype(jnp.int32)
        lm = jnp.where(al, jnp.roll(modes0, 1, axis=1), 2)
        tm = jnp.where(at, jnp.roll(modes0, 1, axis=0), 2)
        mpm = jnp.where(al & at, jnp.minimum(lm, tm), 2)
        # pass 2: +3*lambda for every non-MPM mode (analyse.c:173)
        costs = costs + jnp.where(
            jnp.arange(9) == mpm[..., None], 0, 3 * lam4[..., None])
    modes = jnp.argmin(costs, axis=-1).astype(jnp.int32)  # [H4,W4]
    best = jnp.min(costs, axis=-1)
    # -> per-MB raster-block layout + summed cost
    modes_mb = modes.reshape(mbh, 4, mbw, 4).transpose(0, 2, 1, 3) \
        .reshape(mbh, mbw, 16)
    cost_mb = best.reshape(mbh, 4, mbw, 4).transpose(0, 2, 1, 3) \
        .reshape(mbh, mbw, 16).sum(-1)
    if lam is not None:
        # I_4x4 base: lambda*(24 JVT SATD0 + 16 base predmode bits)
        cost_mb = cost_mb + 40 * (jnp.asarray(lam)
                                  * jnp.ones((mbh, mbw), jnp.int32))
    return modes_mb, cost_mb


def _i4_commit_mb(src, left16, top16, tl_mb, al, at, modes16, qp):
    """Exact I4x4 reconstruction of one wavefront strip of MBs
    (vectorized over the [mbh] lanes; 16 sequential z-scan block steps
    as a lax.fori_loop — compiled ONCE, not unrolled into the wavefront
    scan body; r3 verdict compile-time item).

    All neighbor reads go through one extension buffer `ext`
    [mbh, 17, 21]: row 0 = top16 (+4 spill cols), col 0 = left16,
    [0,0] = tl_mb, interior = progressive recon — so every z step uses
    the same dynamic-slice pattern regardless of block position.

    src [mbh,16,16] int32; left16/top16 [mbh,16] true decoded MB edges;
    tl_mb [mbh]; al/at [mbh] MB-level availability; modes16 [mbh,16]
    raster-block modes; qp [mbh].
    Returns (lv [mbh,16,4,4] raster full 16-coeff blocks, recon)."""
    from ..ops.predict import predict_4x4_all
    mbh = src.shape[0]
    ext = jnp.zeros((mbh, 17, 21), jnp.int32)
    ext = ext.at[:, 0, 0].set(tl_mb)
    ext = ext.at[:, 0, 1:17].set(top16)
    # spill cols 17:21 feed only substituted ('none') top-right reads
    ext = ext.at[:, 0, 17:21].set(top16[:, 15:16])
    ext = ext.at[:, 1:17, 0].set(left16)
    zx = jnp.asarray(I4_ZX.astype(np.int32))
    zy = jnp.asarray(I4_ZY.astype(np.int32))
    # above-right availability kind per raster block (0 none/1 lane/2 real)
    kind_r = np.zeros(16, np.int32)
    for r in range(16):
        kind_r[r] = {"none": 0, "lane": 1,
                     "real": 2}[_i4_block_avail(r % 4, r // 4)]
    kind_t = jnp.asarray(kind_r)
    lv_all = jnp.zeros((mbh, 16, 4, 4), jnp.int32)

    def body(z, carry):
        ext, lv_all = carry
        bx, by = zx[z], zy[z]
        r = by * 4 + bx                       # raster block index
        c4, r4 = bx * 4, by * 4
        left4 = jax.lax.dynamic_slice(ext, (0, r4 + 1, c4),
                                      (mbh, 4, 1))[:, :, 0]
        top8r = jax.lax.dynamic_slice(ext, (0, r4, c4 + 1),
                                      (mbh, 1, 8))[:, 0]
        tl = jax.lax.dynamic_slice(ext, (0, r4, c4), (mbh, 1, 1))[:, 0, 0]
        kind = kind_t[r]
        tr_ok = jnp.where(kind == 2, True, jnp.where(kind == 1, at, False))
        sub = jnp.broadcast_to(top8r[:, 3:4], (mbh, 4))
        top8 = jnp.concatenate(
            [top8r[:, :4], jnp.where(tr_ok[:, None], top8r[:, 4:], sub)],
            axis=-1)
        al_b = jnp.where(bx > 0, True, al)
        at_b = jnp.where(by > 0, True, at)
        preds = predict_4x4_all(left4, top8, tl, al_b, at_b)  # [mbh,9,4,4]
        mode = jax.lax.dynamic_slice(modes16, (0, r), (mbh, 1))[:, 0]
        pred = _onehot_mode(preds, mode, 9)
        srcb = jax.lax.dynamic_slice(src, (0, r4, c4), (mbh, 4, 4))
        res = srcb.astype(jnp.int32) - pred
        w = dct.dct4x4(res[:, None])                  # [mbh,1,4,4]
        lv = quant.quant4x4(w, qp[:, None], True)
        d = quant.dequant4x4(lv, qp[:, None])
        rb = jnp.clip(pred + dct.idct4x4(d)[:, 0], 0, 255)
        ext = jax.lax.dynamic_update_slice(ext, rb, (0, r4 + 1, c4 + 1))
        lv_all = jax.lax.dynamic_update_slice(
            lv_all, lv, (0, r, 0, 0))
        return ext, lv_all

    ext, lv_all = jax.lax.fori_loop(0, 16, body, (ext, lv_all))
    return lv_all, ext[:, 1:17, 1:17]


# ------------------------------------------------------------------ commit
def _gather_edges(pad, mbx, mby, s):
    """From a padded plane [(H+1),(W+1)] gather top [L,s], left [L,s],
    tl [L] for MBs at (mbx,mby) in units of s."""
    r0 = mby * s
    c0 = mbx * s
    ar = jnp.arange(s, dtype=jnp.int32)
    top = pad[r0[:, None], c0[:, None] + 1 + ar[None, :]]
    left = pad[r0[:, None] + 1 + ar[None, :], c0[:, None]]
    tl = pad[r0, c0]
    return top, left, tl


def _luma_blocks(mb):
    """[L,16,16] -> [L,16,4,4] raster 4x4 blocks."""
    L = mb.shape[0]
    return mb.reshape(L, 4, 4, 4, 4).swapaxes(2, 3).reshape(L, 16, 4, 4)


def _luma_merge(blocks):
    """[L,16,4,4] -> [L,16,16]"""
    L = blocks.shape[0]
    return blocks.reshape(L, 4, 4, 4, 4).swapaxes(2, 3).reshape(L, 16, 16)


def _chroma_blocks(mb):
    L = mb.shape[0]
    return mb.reshape(L, 2, 4, 2, 4).swapaxes(2, 3).reshape(L, 4, 4, 4)


def _chroma_merge(blocks):
    L = blocks.shape[0]
    return blocks.reshape(L, 2, 2, 4, 4).swapaxes(2, 3).reshape(L, 8, 8)


def _encode_luma_i16(src, pred, qp):
    """I16x16 luma transform path for [L] MBs. Returns (dc_lv [L,4,4],
    ac_lv [L,16,4,4] pos0-zeroed, recon [L,16,16])."""
    res = src.astype(jnp.int32) - pred
    blocks = _luma_blocks(res)                       # [L,16,4,4]
    w = dct.dct4x4(blocks)
    dcs = w[:, :, 0, 0].reshape(-1, 4, 4)            # raster DC grid
    had = dct.dct4x4dc(dcs)
    dc_lv = quant.quant4x4_dc(had, qp)
    ac_lv = quant.quant4x4(w, qp[:, None], True)
    ac_lv = ac_lv.at[:, :, 0, 0].set(0)
    # reconstruction
    f = dct.ihadamard4x4(dc_lv)
    dc_vals = quant.dequant4x4_dc(f, qp)
    d = quant.dequant4x4(ac_lv, qp[:, None])
    d = d.at[:, :, 0, 0].set(dc_vals.reshape(-1, 16))
    r = dct.idct4x4(d)
    recon = jnp.clip(pred + _luma_merge(r), 0, 255)
    return dc_lv, ac_lv, recon


def _encode_chroma_i8(src, pred, qpc):
    """Chroma 8x8 path (one component). Returns (dc_lv [L,2,2],
    ac_lv [L,4,4,4] pos0-zeroed, recon [L,8,8])."""
    res = src.astype(jnp.int32) - pred
    blocks = _chroma_blocks(res)                     # [L,4,4,4]
    w = dct.dct4x4(blocks)
    dcs = w[:, :, 0, 0].reshape(-1, 2, 2)
    had = dct.hadamard2x2(dcs)
    dc_lv = quant.quant2x2_dc(had, qpc, True)
    ac_lv = quant.quant4x4(w, qpc[:, None], True)
    ac_lv = ac_lv.at[:, :, 0, 0].set(0)
    f = dct.ihadamard2x2(dc_lv)
    dc_vals = quant.dequant2x2_dc(f, qpc)
    d = quant.dequant4x4(ac_lv, qpc[:, None])
    d = d.at[:, :, 0, 0].set(dc_vals.reshape(-1, 4))
    r = dct.idct4x4(d)
    recon = jnp.clip(pred + _chroma_merge(r), 0, 255)
    return dc_lv, ac_lv, recon


def _onehot_mode(preds, mode, n_modes):
    """Select preds[:, mode] without a gather: [L, M, s, s] x [L] -> [L,s,s].
    Invalid/garbage lanes select mode 0's shape safely (mode clipped)."""
    sel = (mode[:, None] == jnp.arange(n_modes, dtype=mode.dtype)[None, :])
    return jnp.sum(jnp.where(sel[:, :, None, None], preds, 0), axis=1)


def commit_scan(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
                mbw, mbh, is_intra=None, inter_planes=None,
                i4_mask=None, i4_modes=None):
    """Wavefront commit in SKEWED layout (ops/skew.py): exact recon with
    true decoded neighbors, every diagonal step static-shaped dynamic-slice
    work over the mbh lanes of one anti-diagonal.

    Mixed-frame mode (is_intra + inter_planes given, the intra-in-P path,
    analyse.c:2939): non-intra MBs take their tiles from the precomputed
    inter reconstruction; intra MBs predict from the true mixed recon.

    I4x4 (i4_mask [mbh,mbw] + i4_modes [mbh,mbw,16]): those intra MBs
    reconstruct via the 16-step z-scan inner loop instead of I16; their
    full 16-coeff blocks ride in the "ac" slot with dc = 0.

    Returns (coeff dict of raster [N, ...] tensors, recon planes)."""
    from ..ops import skew
    H, W = y.shape
    Hc = H // 2
    D = skew.n_diags(mbw, mbh)
    P = 2                           # pad strips: window needs d-2, d-1, d
    ys_src = skew.skew_plane(y.astype(jnp.int16), 16, P)
    us_src = skew.skew_plane(u.astype(jnp.int16), 8, P)
    vs_src = skew.skew_plane(v.astype(jnp.int16), 8, P)
    cs_src = jnp.stack([us_src, vs_src])
    ys_rec = jnp.zeros_like(ys_src)
    cs_rec = jnp.zeros_like(cs_src)
    i16_sk = skew.skew_mb(i16_mode, P)       # [mbh, D+2]
    cm_sk = skew.skew_mb(chroma_mode, P)
    qp_sk = skew.skew_mb(qp_mb, P)
    qpc_sk = skew.skew_mb(qpc_mb, P)
    mixed = is_intra is not None
    if mixed:
        ia_sk = skew.skew_mb(is_intra.astype(jnp.int32), P)
        yi_sk = skew.skew_plane(inter_planes[0].astype(jnp.int16), 16, P)
        ci_sk = jnp.stack(
            [skew.skew_plane(inter_planes[1].astype(jnp.int16), 8, P),
             skew.skew_plane(inter_planes[2].astype(jnp.int16), 8, P)])
    with_i4 = i4_mask is not None
    if with_i4:
        i4_sk = skew.skew_mb(i4_mask.astype(jnp.int32), P)
        i4m_sk = jnp.stack(
            [skew.skew_mb(i4_modes[:, :, k].astype(jnp.int32), P)
             for k in range(16)], axis=-1)       # [mbh, D+P, 16]
    lanes = jnp.arange(mbh, dtype=jnp.int32)

    def step(carry, d):
        ys, cs = carry
        x = d - lanes
        valid = (x >= 0) & (x < mbw)
        al = valid & (x > 0)
        at = valid & (lanes > 0)

        win = jax.lax.dynamic_slice(ys, (0, d * 16), (H, 48)) \
            .reshape(mbh, 16, 48)
        cwin = jax.lax.dynamic_slice(cs, (0, 0, d * 8), (2, Hc, 24)) \
            .reshape(2, mbh, 8, 24)
        src = jax.lax.dynamic_slice(ys_src, (0, (d + P) * 16), (H, 16)) \
            .reshape(mbh, 16, 16)
        csrc = jax.lax.dynamic_slice(cs_src, (0, 0, (d + P) * 8),
                                     (2, Hc, 8)).reshape(2, mbh, 8, 8)
        mode = jax.lax.dynamic_slice(i16_sk, (0, d + P), (mbh, 1))[:, 0]
        cmode = jax.lax.dynamic_slice(cm_sk, (0, d + P), (mbh, 1))[:, 0]
        qp = jax.lax.dynamic_slice(qp_sk, (0, d + P), (mbh, 1))[:, 0]
        qpc = jax.lax.dynamic_slice(qpc_sk, (0, d + P), (mbh, 1))[:, 0]
        if mixed:
            ilane = jax.lax.dynamic_slice(
                ia_sk, (0, d + P), (mbh, 1))[:, 0] > 0
            yi = jax.lax.dynamic_slice(
                yi_sk, (0, (d + P) * 16), (H, 16)).reshape(mbh, 16, 16)
            ci = jax.lax.dynamic_slice(
                ci_sk, (0, 0, (d + P) * 8),
                (2, Hc, 8)).reshape(2, mbh, 8, 8)

        # ---- luma neighbors (strip d-1 = win cols 16:32, d-2 = 0:16) ----
        mid = win[:, :, 16:32]
        prev_mid = jnp.concatenate([jnp.zeros_like(mid[:1]), mid[:-1]],
                                   axis=0)
        top = prev_mid[:, 15, :].astype(jnp.int32)          # [mbh, 16]
        left = mid[:, :, 15].astype(jnp.int32)              # [mbh, 16]
        tl_col = win[:, 15, 15]
        tl = jnp.concatenate([jnp.zeros_like(tl_col[:1]),
                              tl_col[:-1]]).astype(jnp.int32)
        preds = predict.predict_16x16_all(left, top, tl, al, at)
        pred = _onehot_mode(preds, mode, 4)
        dc_lv, ac_lv, recon = _encode_luma_i16(src, pred, qp)
        if with_i4:
            i4lane = jax.lax.dynamic_slice(
                i4_sk, (0, d + P), (mbh, 1))[:, 0] > 0
            m16 = jax.lax.dynamic_slice(
                i4m_sk, (0, d + P, 0), (mbh, 1, 16)).reshape(mbh, 16)
            lv4, rec4 = _i4_commit_mb(src, left, top, tl, al, at, m16, qp)
            il3 = i4lane[:, None, None]
            recon = jnp.where(il3, rec4, recon)
            ac_lv = jnp.where(i4lane[:, None, None, None], lv4, ac_lv)
            dc_lv = jnp.where(il3, 0, dc_lv)
        if mixed:
            recon = jnp.where(ilane[:, None, None], recon,
                              yi.astype(recon.dtype))
            dc_lv = jnp.where(ilane[:, None, None], dc_lv, 0)
            ac_lv = jnp.where(ilane[:, None, None, None], ac_lv, 0)
        ys = jax.lax.dynamic_update_slice(
            ys, recon.astype(ys.dtype).reshape(H, 16), (0, (d + P) * 16))

        # ---- chroma ----
        cmid = cwin[:, :, :, 8:16]
        cprev = jnp.concatenate([jnp.zeros_like(cmid[:, :1]), cmid[:, :-1]],
                                axis=1)
        ctop = cprev[:, :, 7, :].astype(jnp.int32)          # [2, mbh, 8]
        cleft = cmid[:, :, :, 7].astype(jnp.int32)
        ctl_col = cwin[:, :, 7, 7]
        ctl = jnp.concatenate([jnp.zeros_like(ctl_col[:, :1]),
                               ctl_col[:, :-1]], axis=1).astype(jnp.int32)
        pu_all = predict.predict_chroma_all(cleft[0], ctop[0], ctl[0],
                                            al, at)
        pv_all = predict.predict_chroma_all(cleft[1], ctop[1], ctl[1],
                                            al, at)
        pred_u = _onehot_mode(pu_all, cmode, 4)
        pred_v = _onehot_mode(pv_all, cmode, 4)
        udc, uac, urec = _encode_chroma_i8(csrc[0], pred_u, qpc)
        vdc, vac, vrec = _encode_chroma_i8(csrc[1], pred_v, qpc)
        if mixed:
            il3 = ilane[:, None, None]
            urec = jnp.where(il3, urec, ci[0].astype(urec.dtype))
            vrec = jnp.where(il3, vrec, ci[1].astype(vrec.dtype))
            udc = jnp.where(il3, udc, 0)
            vdc = jnp.where(il3, vdc, 0)
            uac = jnp.where(ilane[:, None, None, None], uac, 0)
            vac = jnp.where(ilane[:, None, None, None], vac, 0)
        crec = jnp.stack([urec, vrec]).astype(cs.dtype).reshape(2, Hc, 8)
        cs = jax.lax.dynamic_update_slice(cs, crec, (0, 0, (d + P) * 8))

        out = {"dc": dc_lv, "ac": ac_lv,
               "udc": udc, "uac": uac, "vdc": vdc, "vac": vac}
        return (ys, cs), out

    (ys_rec, cs_rec), outs = jax.lax.scan(
        step, (ys_rec, cs_rec), jnp.arange(D, dtype=jnp.int32))
    recon = (skew.unskew_plane(ys_rec, 16, mbw, P).astype(jnp.uint8),
             skew.unskew_plane(cs_rec[0], 8, mbw, P).astype(jnp.uint8),
             skew.unskew_plane(cs_rec[1], 8, mbw, P).astype(jnp.uint8))
    coeffs = {k: skew.unskew_scan_outputs(v, mbw) for k, v in outs.items()}
    return coeffs, recon


@partial(jax.jit, static_argnames=("mbw", "mbh"))
def commit_i16x16(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
                  *, mbw, mbh):
    """All-intra wavefront commit (I frames). See commit_scan."""
    return commit_scan(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
                       mbw, mbh)


@partial(jax.jit, static_argnames=("mbw", "mbh", "cap_words", "deblock",
                                   "a_off", "b_off", "cqpo", "i4"))
def encode_iframe_device(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh,
                         cap_words, deblock=False, a_off=0, b_off=0,
                         cqpo=0, i4=False):
    """Fused device pass: mode decision + wavefront commit + CAVLC entropy +
    bit packing (+ in-loop deblock) — the whole frame in one dispatch. Only
    the packed slice payload (and recon, for the DPB) leaves the chip.

    i4=True adds the I_4x4 candidate (analyse.c:668): per-MB choose
    I16x16 vs I4x4 by SATD + reference mode-bit costs (per-MB lambda,
    so AQ offsets steer the decision like ratecontrol_mb_qp does)."""
    from ..entropy.cavlc_jax import encode_i16x16_frame_dev
    lam_mb = jnp.maximum(
        1, jnp.round(2.0 ** ((qp_mb - 12) / 6.0))).astype(jnp.int32)
    i16_mode, chroma_mode, satd_cost, i16_cost = decide_modes_full(
        y, u, v, lam=lam_mb)
    if i4:
        i4_modes, i4_cost = decide_modes_i4(y, lam=lam_mb)
        i4_mask = i4_cost < i16_cost
        coeffs, recon = commit_scan(
            y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
            i4_mask=i4_mask, i4_modes=i4_modes)
    else:
        i4_mask = i4_modes = None
        coeffs, recon = commit_i16x16(y, u, v, i16_mode, chroma_mode,
                                      qp_mb, qpc_mb, mbw=mbw, mbh=mbh)
    dc_blk = coeffs["dc"]
    ac_blk = coeffs["ac"]
    cdc_blk = jnp.stack([coeffs["udc"], coeffs["vdc"]], axis=1)
    cac_blk = jnp.stack([coeffs["uac"], coeffs["vac"]], axis=1)
    qp_flat = qp_mb.reshape(-1)
    words, total_bits, eff_qp = encode_i16x16_frame_dev(
        i16_mode.reshape(-1), chroma_mode.reshape(-1), qp_flat,
        slice_qp, dc_blk, ac_blk, cdc_blk, cac_blk,
        mbw=mbw, mbh=mbh, cap_words=cap_words,
        is_i4=(i4_mask.reshape(-1) if i4 else None),
        i4_modes=(i4_modes.reshape(-1, 16) if i4 else None))
    if deblock:
        from ..ops.deblock import deblock_frame
        bs = jnp.full((mbh, mbw, 4, 4), 3, jnp.int32)
        bs = bs.at[:, :, 0, :].set(4)     # all-intra: MB edges strong
        recon = deblock_frame(
            recon[0], recon[1], recon[2], bs, bs,
            eff_qp.reshape(mbh, mbw), mbw=mbw, mbh=mbh,
            a_off=a_off, b_off=b_off, chroma_qp_offset=cqpo)
    n_i4 = (jnp.sum(i4_mask) if i4 else jnp.asarray(0, jnp.int32))
    return words, total_bits, recon, satd_cost, n_i4


@partial(jax.jit, static_argnames=("mbw", "mbh", "deblock", "a_off",
                                   "b_off", "cqpo", "i4"))
def analyze_iframe_device(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh,
                          deblock=False, a_off=0, b_off=0, cqpo=0,
                          i4=False):
    """Device pass for the CABAC path: decide + commit + deblock, returning
    zigzagged levels for the host CABAC writer (native/cabac.cpp) instead
    of running the device CAVLC stage. With i4, the per-MB I_4x4 candidate
    is added (analyse.c:668) and the deblock qp map follows the
    decoder-carried chain (dqp is only signaled for I4 MBs with
    residual)."""
    lam_mb = jnp.maximum(
        1, jnp.round(2.0 ** ((qp_mb - 12) / 6.0))).astype(jnp.int32)
    i16_mode, chroma_mode, satd_cost, i16_cost = decide_modes_full(
        y, u, v, lam=lam_mb)
    if i4:
        i4_modes, i4_cost = decide_modes_i4(y, lam=lam_mb)
        i4_mask = i4_cost < i16_cost
        coeffs, recon = commit_scan(
            y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb, mbw, mbh,
            i4_mask=i4_mask, i4_modes=i4_modes)
    else:
        i4_mask = jnp.zeros((mbh, mbw), bool)
        i4_modes = jnp.zeros((mbh, mbw, 16), jnp.int32)
        coeffs, recon = commit_i16x16(y, u, v, i16_mode, chroma_mode,
                                      qp_mb, qpc_mb, mbw=mbw, mbh=mbh)
    n = mbw * mbh
    # decoder-carried qp chain (mirrors entropy/cavlc_jax.py): dqp is
    # always signaled for I16 MBs, only with residual for I4 MBs
    qp_flat = qp_mb.reshape(-1)
    luma_any = (coeffs["ac"].reshape(n, -1) != 0).any(axis=1)
    chroma_any = ((coeffs["udc"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["vdc"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["uac"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["vac"].reshape(n, -1) != 0).any(axis=1))
    has_dqp = (~i4_mask.reshape(-1)) | luma_any | chroma_any
    idxs = jnp.arange(n, dtype=jnp.int32)
    last_d = jax.lax.cummax(jnp.where(has_dqp, idxs, -1))
    prev_d = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_d[:-1]])
    prev_qp = jnp.where(prev_d >= 0, qp_flat[jnp.maximum(prev_d, 0)],
                        slice_qp)
    eff_qp = jnp.where(has_dqp, qp_flat, prev_qp)
    if deblock:
        from ..ops.deblock import deblock_frame
        bs = jnp.full((mbh, mbw, 4, 4), 3, jnp.int32)
        bs = bs.at[:, :, 0, :].set(4)
        recon = deblock_frame(
            recon[0], recon[1], recon[2], bs, bs,
            eff_qp.reshape(mbh, mbw), mbw=mbw, mbh=mbh,
            a_off=a_off, b_off=b_off, chroma_qp_offset=cqpo)
    zig = jnp.asarray(ZIGZAG4_FRAME)
    dc_z = coeffs["dc"].reshape(n, 16)[:, zig]
    ac_z = coeffs["ac"].reshape(n, 16, 16)[:, :, zig]
    cdc = jnp.stack([coeffs["udc"], coeffs["vdc"]], axis=1).reshape(n, 2, 4)
    cac = jnp.stack([coeffs["uac"], coeffs["vac"]],
                    axis=1).reshape(n, 2, 4, 16)[:, :, :, zig]
    return (i16_mode.reshape(-1), chroma_mode.reshape(-1), dc_z, ac_z,
            cdc, cac, recon, satd_cost, i4_mask.reshape(-1),
            i4_modes.reshape(n, 16))


# ---------------------------------------------------------------------
# Staged I-frame pipeline (r4 verdict item 4: compile time). Same math
# as encode_iframe_device / analyze_iframe_device, but each stage under
# its own jit so the programs compile independently and
# Encoder.precompile can warm them CONCURRENTLY (encoder/stagewarm.py).
# ---------------------------------------------------------------------


@partial(jax.jit, static_argnames=("i4",))
def i_stage_decide(y, u, v, qp_mb, *, i4):
    """Stage: intra mode decision at per-MB lambda (analyse.c:668)."""
    lam_mb = jnp.maximum(
        1, jnp.round(2.0 ** ((qp_mb - 12) / 6.0))).astype(jnp.int32)
    i16_mode, chroma_mode, satd_cost, i16_cost = decide_modes_full(
        y, u, v, lam=lam_mb)
    if i4:
        i4_modes, i4_cost = decide_modes_i4(y, lam=lam_mb)
        i4_mask = i4_cost < i16_cost
    else:
        mbh, mbw = qp_mb.shape
        i4_mask = jnp.zeros((mbh, mbw), bool)
        i4_modes = jnp.zeros((mbh, mbw, 16), jnp.int32)
    return i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes


@partial(jax.jit, static_argnames=("mbw", "mbh", "with_i4"))
def i_stage_commit(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
                   i4_mask=None, i4_modes=None, *, mbw, mbh, with_i4):
    """Stage: wavefront commit (exact recon + levels)."""
    if with_i4:
        return commit_scan(y, u, v, i16_mode, chroma_mode, qp_mb,
                           qpc_mb, mbw, mbh, i4_mask=i4_mask,
                           i4_modes=i4_modes)
    return commit_scan(y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
                       mbw, mbh)


@partial(jax.jit, static_argnames=("mbw", "mbh", "a_off", "b_off",
                                   "cqpo"))
def i_stage_deblock(ry, ru, rv, eff_qp, *, mbw, mbh, a_off, b_off, cqpo):
    """Stage: all-intra in-loop deblock (MB edges strong)."""
    from ..ops.deblock import deblock_frame
    bs = jnp.full((mbh, mbw, 4, 4), 3, jnp.int32)
    bs = bs.at[:, :, 0, :].set(4)
    return deblock_frame(ry, ru, rv, bs, bs, eff_qp.reshape(mbh, mbw),
                         mbw=mbw, mbh=mbh, a_off=a_off, b_off=b_off,
                         chroma_qp_offset=cqpo)


@partial(jax.jit, static_argnames=("mbw", "mbh"))
def i_stage_pack_cabac(coeffs, i4_mask, qp_mb, slice_qp, *, mbw, mbh):
    """Stage: decoder-carried qp chain + zigzag packing for the host
    C++ CABAC writer (mirrors the tail of analyze_iframe_device)."""
    n = mbw * mbh
    qp_flat = qp_mb.reshape(-1)
    luma_any = (coeffs["ac"].reshape(n, -1) != 0).any(axis=1)
    chroma_any = ((coeffs["udc"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["vdc"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["uac"].reshape(n, -1) != 0).any(axis=1)
                  | (coeffs["vac"].reshape(n, -1) != 0).any(axis=1))
    has_dqp = (~i4_mask.reshape(-1)) | luma_any | chroma_any
    idxs = jnp.arange(n, dtype=jnp.int32)
    last_d = jax.lax.cummax(jnp.where(has_dqp, idxs, -1))
    prev_d = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                              last_d[:-1]])
    prev_qp = jnp.where(prev_d >= 0, qp_flat[jnp.maximum(prev_d, 0)],
                        slice_qp)
    eff_qp = jnp.where(has_dqp, qp_flat, prev_qp)
    zig = jnp.asarray(ZIGZAG4_FRAME)
    dc_z = coeffs["dc"].reshape(n, 16)[:, zig]
    ac_z = coeffs["ac"].reshape(n, 16, 16)[:, :, zig]
    cdc = jnp.stack([coeffs["udc"], coeffs["vdc"]],
                    axis=1).reshape(n, 2, 4)
    cac = jnp.stack([coeffs["uac"], coeffs["vac"]],
                    axis=1).reshape(n, 2, 4, 16)[:, :, :, zig]
    return dc_z, ac_z, cdc, cac, eff_qp


def encode_iframe_staged(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh,
                         cap_words, deblock=False, a_off=0, b_off=0,
                         cqpo=0, i4=False):
    """Staged twin of encode_iframe_device (same outputs)."""
    from ..entropy.cavlc_jax import encode_i16x16_frame_dev
    from .stagewarm import stage as _st
    i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes = \
        _st(i_stage_decide)(y, u, v, qp_mb, i4=i4)
    coeffs, recon = _st(i_stage_commit)(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
        i4_mask if i4 else None, i4_modes if i4 else None,
        mbw=mbw, mbh=mbh, with_i4=i4)
    dc_blk = coeffs["dc"]
    ac_blk = coeffs["ac"]
    cdc_blk = jnp.stack([coeffs["udc"], coeffs["vdc"]], axis=1)
    cac_blk = jnp.stack([coeffs["uac"], coeffs["vac"]], axis=1)
    qp_flat = qp_mb.reshape(-1)
    words, total_bits, eff_qp = _st(encode_i16x16_frame_dev)(
        i16_mode.reshape(-1), chroma_mode.reshape(-1), qp_flat,
        slice_qp, dc_blk, ac_blk, cdc_blk, cac_blk,
        mbw=mbw, mbh=mbh, cap_words=cap_words,
        is_i4=(i4_mask.reshape(-1) if i4 else None),
        i4_modes=(i4_modes.reshape(-1, 16) if i4 else None))
    if deblock:
        recon = _st(i_stage_deblock)(
            recon[0], recon[1], recon[2], eff_qp, mbw=mbw, mbh=mbh,
            a_off=a_off, b_off=b_off, cqpo=cqpo)
    n_i4 = (jnp.sum(i4_mask) if i4 else jnp.asarray(0, jnp.int32))
    return words, total_bits, recon, satd_cost, n_i4


def analyze_iframe_staged(y, u, v, qp_mb, qpc_mb, slice_qp, *, mbw, mbh,
                          deblock=False, a_off=0, b_off=0, cqpo=0,
                          i4=False):
    """Staged twin of analyze_iframe_device (same outputs)."""
    from .stagewarm import stage as _st
    i16_mode, chroma_mode, satd_cost, i4_mask, i4_modes = \
        _st(i_stage_decide)(y, u, v, qp_mb, i4=i4)
    coeffs, recon = _st(i_stage_commit)(
        y, u, v, i16_mode, chroma_mode, qp_mb, qpc_mb,
        i4_mask if i4 else None, i4_modes if i4 else None,
        mbw=mbw, mbh=mbh, with_i4=i4)
    n = mbw * mbh
    dc_z, ac_z, cdc, cac, eff_qp = _st(i_stage_pack_cabac)(
        coeffs, i4_mask, qp_mb, slice_qp, mbw=mbw, mbh=mbh)
    if deblock:
        recon = _st(i_stage_deblock)(
            recon[0], recon[1], recon[2], eff_qp, mbw=mbw, mbh=mbh,
            a_off=a_off, b_off=b_off, cqpo=cqpo)
    return (i16_mode.reshape(-1), chroma_mode.reshape(-1), dc_z, ac_z,
            cdc, cac, recon, satd_cost, i4_mask.reshape(-1),
            i4_modes.reshape(n, 16))



def finalize_slice_cabac(enc, payload: bytes, sh, nal_type, ref_idc):
    """Slice header + cabac_alignment_one_bits + CABAC payload -> NAL."""
    bw = slice_header_write(sh, ref_idc)
    bw.byte_align_one()
    bw.extend_bytes(payload)
    return [nal_mod.nal_encode(nal_type, ref_idc, bw.getvalue())]


def cabac_finalize_iframe(enc, mode_m, mode_c, dc_z, ac_z, cdc, cac,
                          qp_mb, slice_qp, sh, nal_type, ref_idc,
                          is_i4=None, i4_modes=None):
    """Host tail of a CABAC I frame: transfer levels, run the C++ writer."""
    from ..entropy.cabac_host import encode_slice_cabac
    from ..entropy.cavlc import LUMA4x4_RASTER
    mbw, mbh = enc.mb_w, enc.mb_h
    n = mbw * mbh
    # blocks raster in tensors -> z-scan coding order for the writer
    ac = np.asarray(ac_z, np.int16)[:, LUMA4x4_RASTER]
    cacn = np.asarray(cac, np.int16)
    cdcn = np.asarray(cdc, np.int16)
    cbp_luma = np.where((ac[:, :, 1:] != 0).any(axis=(1, 2)), 15, 0)
    if is_i4 is not None:
        is_i4 = np.asarray(is_i4, np.uint8)
        # I4 MBs: per-8x8-quad cbp over the full 16-coeff blocks
        # (z-scan groups 4 consecutive blocks per quad)
        quad_nz = (ac != 0).any(axis=2).reshape(n, 4, 4).any(axis=2)
        cbp_i4 = (quad_nz.astype(np.int32)
                  << np.arange(4)[None, :]).sum(axis=1)
        cbp_luma = np.where(is_i4 > 0, cbp_i4, cbp_luma)
    any_cac = (cacn[:, :, :, 1:] != 0).any(axis=(1, 2, 3))
    any_cdc = (cdcn != 0).any(axis=(1, 2))
    cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0))
    payload = encode_slice_cabac(
        True, mbw, mbh, slice_qp,
        np.zeros(n, np.uint8), np.ones(n, np.uint8),
        np.asarray(mode_m), np.asarray(mode_c),
        cbp_luma, cbp_chroma, np.asarray(qp_mb).reshape(-1),
        np.zeros((n, 2), np.int16),
        np.asarray(dc_z, np.int16), ac, cdcn,
        cacn.reshape(n, 8, 16),
        is_i4=is_i4,
        i4_modes=(np.asarray(i4_modes, np.uint8)
                  if i4_modes is not None else None))
    return finalize_slice_cabac(enc, payload, sh, nal_type, ref_idc)


def dispatch_iframe_cabac(enc, planes, ftype, qp, tree_off=None):
    """CABAC I-frame dispatch: device analysis/commit, host entropy."""
    mbw, mbh = enc.mb_w, enc.mb_h
    y, u, v = [jnp.asarray(p) for p in planes]
    sh = enc._slice_header(ftype, qp)
    nal_type = (nal_mod.NAL_SLICE_IDR if ftype == TYPE_IDR
                else nal_mod.NAL_SLICE)
    # frame_num/poc transitions are owned by the orchestrator (encoder.py)
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)

    def attempt(qp_try):
        from .frame_encode import build_qp_maps
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try, tree_off)
        from ..params import ANALYSE_I4x4
        (mode_m, mode_c, dc_z, ac_z, cdc, cac, recon,
         satd_cost, is_i4, i4_modes) = analyze_iframe_staged(
            y, u, v, qp_mb, qpc_mb, qp_try, mbw=mbw, mbh=mbh,
            deblock=enc.p.deblocking_filter,
            a_off=enc.p.deblocking_filter_alphac0 * 2,
            b_off=enc.p.deblocking_filter_beta * 2,
            cqpo=enc.p.analyse.chroma_qp_offset,
            i4=bool(enc.p.analyse.intra & ANALYSE_I4x4))
        enc._pending_ref_fields = {
            "mvf": np.zeros((mbh, mbw, 2), np.int32),
            "inter_mask": np.zeros((mbh, mbw), bool)}

        def finalize():
            sh.qp = qp_try
            nals = cabac_finalize_iframe(
                enc, mode_m, mode_c, dc_z, ac_z, cdc, cac, qp_mb, qp_try,
                sh, nal_type, nal_mod.NAL_PRIORITY_HIGHEST,
                is_i4=is_i4, i4_modes=i4_modes)
            rec = [np.asarray(r) for r in recon] if materialize \
                else list(recon)
            enc.rc.end(ftype, sum(len(n.payload) * 8 for n in nals),
                       float(satd_cost), qp_try)
            return nals, rec

        return finalize, list(recon)

    finalize, recon = attempt(qp)
    return finalize, attempt, recon, None


# ------------------------------------------------------------- frame entry
_SCHED_CACHE = {}

CAP_BYTES_PER_MB = 450    # device payload buffer budget (asserted on host)


def cap_bytes_per_mb(qp: int) -> int:
    """Per-MB payload budget by QP (worst-case noise frames at low QP run
    to ~3700 bits/MB; the budget must exceed that or every frame would
    take the overflow re-encode path)."""
    if qp >= 16:
        return CAP_BYTES_PER_MB
    if qp >= 8:
        return 2 * CAP_BYTES_PER_MB
    return 3 * CAP_BYTES_PER_MB


def aud_nal(ftype):
    """Access unit delimiter (spec 7.3.1; reference --aud)."""
    from ..entropy.bits import BitWriter
    bw = BitWriter()
    # primary_pic_type: 0 = I only, 1 = I+P
    bw.write(3, 0 if ftype in (TYPE_IDR,) else 1)
    bw.rbsp_trailing()
    return nal_mod.nal_encode(nal_mod.NAL_AUD,
                              nal_mod.NAL_PRIORITY_DISPOSABLE,
                              bw.getvalue())


class PayloadOverflow(Exception):
    """Device CAVLC buffer overflow — caller re-encodes at higher QP
    (reference analogue: encoder.c:2893-2902 overflow re-encode)."""


def finalize_slice(enc, words, total_bits, cap_words, sh, nal_type,
                   ref_idc):
    """Host tail of a frame: sync payload, merge after the slice header.
    Shared by I and P paths; runs one frame behind the device when the
    host pipeline (frame-threads analogue) is active."""
    from ..entropy.bits import append_bitstring
    from ..entropy.cavlc_jax import words_to_bytes
    total_bits = int(total_bits)
    if total_bits > cap_words * 32 - 32:
        raise PayloadOverflow(f"{total_bits} bits > cap")
    n_words = (total_bits + 31) // 32
    payload, nbits = words_to_bytes(np.asarray(words[:n_words]), total_bits)
    bw = slice_header_write(sh, ref_idc)
    append_bitstring(bw, payload, nbits)
    bw.rbsp_trailing()
    return [nal_mod.nal_encode(nal_type, ref_idc, bw.getvalue())]


def dispatch_iframe(enc, planes, ftype, qp, tree_off=None):
    """Device dispatch of a full I-frame (decide -> commit -> CAVLC).
    Returns (finalize_fn, retry_fn, recon_device)."""
    if enc.p.cabac:
        return dispatch_iframe_cabac(enc, planes, ftype, qp, tree_off)
    mbw, mbh = enc.mb_w, enc.mb_h
    y, u, v = [jnp.asarray(p) for p in planes]
    sh = enc._slice_header(ftype, qp)
    nal_type = (nal_mod.NAL_SLICE_IDR if ftype == TYPE_IDR
                else nal_mod.NAL_SLICE)
    # frame_num/poc transitions are owned by the orchestrator (encoder.py)
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)

    def attempt(qp_try):
        from .frame_encode import build_qp_maps
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try, tree_off)
        cap_bpm = cap_bytes_per_mb(qp_try)
        cap_words = (mbw * mbh * cap_bpm) // 4
        from ..params import ANALYSE_I4x4
        words, total_bits, recon, satd_cost, n_i4 = encode_iframe_staged(
            y, u, v, qp_mb, qpc_mb, qp_try,
            mbw=mbw, mbh=mbh, cap_words=cap_words,
            deblock=enc.p.deblocking_filter,
            a_off=enc.p.deblocking_filter_alphac0 * 2,
            b_off=enc.p.deblocking_filter_beta * 2,
            cqpo=enc.p.analyse.chroma_qp_offset,
            i4=bool(enc.p.analyse.intra & ANALYSE_I4x4))
        enc._pending_ref_fields = {
            "mvf": np.zeros((mbh, mbw, 2), np.int32),
            "inter_mask": np.zeros((mbh, mbw), bool)}

        def finalize():
            sh.qp = qp_try
            nals = finalize_slice(enc, words, total_bits, cap_words, sh,
                                  nal_type, nal_mod.NAL_PRIORITY_HIGHEST)
            rec = [np.asarray(r) for r in recon] if materialize \
                else list(recon)
            enc.rc.end(ftype, sum(len(n.payload) * 8 for n in nals),
                       float(satd_cost), qp_try)
            return nals, rec

        return finalize, list(recon)

    finalize, recon = attempt(qp)
    return finalize, attempt, recon, None


def encode_iframe(enc, planes, ftype, qp):
    """Synchronous I-frame encode. Returns (nals, recon)."""
    finalize, _, _, _ = dispatch_iframe(enc, planes, ftype, qp)
    return finalize()
