"""In-loop deblocking filter (spec 8.7; reference common/deblock.c).

Design: boundary strengths for the whole frame are computed in one
batched pass (reference deblock_strength_c, deblock.c:277); the filter
itself is a wavefront scan over MBs (the spec's raster V-then-H order has a
left/top dependency exactly like intra prediction), with each diagonal's
MBs filtered in parallel using static in-register edge slices.

Intra prediction reads the UNFILTERED recon, so deblock runs after the
frame's commit pass, and the filtered planes feed the DPB + output.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import tables as T

# spec tables 8-16 / 8-17 (qp 0..51)
ALPHA_TABLE = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255], dtype=np.int32)
BETA_TABLE = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)
TC0_TABLE = np.array(
    [[0, 0, 0]] * 17
    + [[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1], [0, 1, 1],
       [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2], [1, 1, 2],
       [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3], [2, 2, 4],
       [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6], [4, 5, 7],
       [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
       [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
       [13, 17, 25]], dtype=np.int32)


def _clip255(x):
    return jnp.clip(x, 0, 255)


def filter_lines_luma(p, q, bs, alpha, beta, tc0):
    """Filter luma lines across one edge.

    p, q: [..., 4] samples (p[...,0]=p3..p[...,3]=p0; q[...,0]=q0..q3).
    bs, alpha, beta, tc0: broadcastable per-line ints.
    Returns filtered (p, q)."""
    # int32 throughout (exact on every backend)
    p = p.astype(jnp.int32)
    q = q.astype(jnp.int32)
    p3, p2, p1, p0 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    filt = ((bs > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    ap = jnp.abs(p2 - p0) < beta
    aq = jnp.abs(q2 - q0) < beta
    # --- normal filter (bs 1..3) ---
    tc = tc0 + ap.astype(jnp.int32) + aq.astype(jnp.int32)
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip255(p0 + delta)
    nq0 = _clip255(q0 - delta)
    dp1 = jnp.clip((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0)
    dq1 = jnp.clip((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0)
    np1 = jnp.where(ap, p1 + dp1, p1)
    nq1 = jnp.where(aq, q1 + dq1, q1)
    # --- strong filter (bs == 4) ---
    cond = jnp.abs(p0 - q0) < ((alpha >> 2) + 2)
    sp0a = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    sp1a = (p2 + p1 + p0 + q0 + 2) >> 2
    sp2a = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    sp0b = (2 * p1 + p0 + q1 + 2) >> 2
    use_p = ap & cond
    s_p0 = jnp.where(use_p, sp0a, sp0b)
    s_p1 = jnp.where(use_p, sp1a, p1)
    s_p2 = jnp.where(use_p, sp2a, p2)
    sq0a = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    sq1a = (q2 + q1 + q0 + p0 + 2) >> 2
    sq2a = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    sq0b = (2 * q1 + q0 + p1 + 2) >> 2
    use_q = aq & cond
    s_q0 = jnp.where(use_q, sq0a, sq0b)
    s_q1 = jnp.where(use_q, sq1a, q1)
    s_q2 = jnp.where(use_q, sq2a, q2)
    strong = bs == 4
    f_p0 = jnp.where(strong, s_p0, np0)
    f_p1 = jnp.where(strong, s_p1, np1)
    f_p2 = jnp.where(strong, s_p2, p2)
    f_q0 = jnp.where(strong, s_q0, nq0)
    f_q1 = jnp.where(strong, s_q1, nq1)
    f_q2 = jnp.where(strong, s_q2, q2)
    out_p = jnp.stack([p3,
                       jnp.where(filt, f_p2, p2),
                       jnp.where(filt, f_p1, p1),
                       jnp.where(filt, f_p0, p0)], axis=-1)
    out_q = jnp.stack([jnp.where(filt, f_q0, q0),
                       jnp.where(filt, f_q1, q1),
                       jnp.where(filt, f_q2, q2),
                       q3], axis=-1)
    return out_p, out_q


def filter_lines_chroma(p, q, bs, alpha, beta, tc0):
    """Chroma: p,q [..., 2] (p1,p0 | q0,q1)."""
    p = p.astype(jnp.int32)
    q = q.astype(jnp.int32)
    p1, p0 = p[..., 0], p[..., 1]
    q0, q1 = q[..., 0], q[..., 1]
    filt = ((bs > 0) & (jnp.abs(p0 - q0) < alpha)
            & (jnp.abs(p1 - p0) < beta) & (jnp.abs(q1 - q0) < beta))
    tc = tc0 + 1
    delta = jnp.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = _clip255(p0 + delta)
    nq0 = _clip255(q0 - delta)
    s_p0 = (2 * p1 + p0 + q1 + 2) >> 2
    s_q0 = (2 * q1 + q0 + p1 + 2) >> 2
    strong = bs == 4
    f_p0 = jnp.where(strong, s_p0, np0)
    f_q0 = jnp.where(strong, s_q0, nq0)
    out_p = jnp.stack([p1, jnp.where(filt, f_p0, p0)], axis=-1)
    out_q = jnp.stack([jnp.where(filt, f_q0, q0), q1], axis=-1)
    return out_p, out_q


@partial(jax.jit, static_argnames=("mbw", "mbh"))
def compute_strengths(intra_mb, nnz4, mv_mb, *, mbw, mbh, ref_mb=None):
    """Boundary strengths for the whole frame (batched).

    intra_mb [mbh,mbw] bool; nnz4 [mbh*4, mbw*4] int; mv_mb [mbh,mbw,2]
    MB-granular or [mbh*4,mbw*4,2] 4x4-granular (16x8/8x16 partitions;
    P_SKIP counts as inter zero-nnz). ref_mb [mbh,mbw] int32 — per-MB
    L0 refIdx (multi-ref P): blocks predicting from different reference
    pictures get bs >= 1 (spec 8.7.2.1). None = single ref.
    Returns (bs_v, bs_h) [mbh, mbw, 4 edges, 4 lines4]."""
    ih, iw = mbh * 4, mbw * 4
    intra4 = jnp.repeat(jnp.repeat(intra_mb, 4, axis=0), 4, axis=1)
    if mv_mb.shape[0] == ih:
        mv4 = mv_mb                                            # [ih,iw,2]
    else:
        mv4 = jnp.repeat(jnp.repeat(mv_mb, 4, axis=0), 4, axis=1)
    ref4 = None if ref_mb is None else \
        jnp.repeat(jnp.repeat(ref_mb, 4, axis=0), 4, axis=1)

    def edge_bs(axis):
        # p = block shifted by -1 along axis, q = block
        if axis == 1:
            intra_p = jnp.pad(intra4, ((0, 0), (1, 0)))[:, :-1]
            nnz_p = jnp.pad(nnz4, ((0, 0), (1, 0)))[:, :-1]
            mv_p = jnp.pad(mv4, ((0, 0), (1, 0), (0, 0)))[:, :-1]
        else:
            intra_p = jnp.pad(intra4, ((1, 0), (0, 0)))[:-1]
            nnz_p = jnp.pad(nnz4, ((1, 0), (0, 0)))[:-1]
            mv_p = jnp.pad(mv4, ((1, 0), (0, 0), (0, 0)))[:-1]
        either_intra = intra4 | intra_p
        col = jnp.arange(iw)[None, :]
        row = jnp.arange(ih)[:, None]
        mb_edge = (col % 4 == 0) if axis == 1 else \
            jnp.broadcast_to(row % 4 == 0, (ih, iw))
        if axis == 1:
            mb_edge = jnp.broadcast_to(col % 4 == 0, (ih, iw))
        bs_intra = jnp.where(mb_edge, 4, 3)
        nz = (nnz4 > 0) | (nnz_p > 0)
        mv_diff = jnp.any(jnp.abs(mv4 - mv_p) >= 4, axis=-1)
        if ref4 is not None:
            # different reference pictures across the edge -> bs 1
            # (spec 8.7.2.1 clause 4; mv deltas only compared between
            # same-ref blocks)
            if axis == 1:
                ref_px = jnp.pad(ref4, ((0, 0), (1, 0)))[:, :-1]
            else:
                ref_px = jnp.pad(ref4, ((1, 0), (0, 0)))[:-1]
            mv_diff = mv_diff | (ref4 != ref_px)
        bs_inter = jnp.where(nz, 2, jnp.where(mv_diff, 1, 0))
        return jnp.where(either_intra, bs_intra, bs_inter)

    bs_v_grid = edge_bs(1)    # [ih, iw]: strength of edge LEFT of block
    bs_h_grid = edge_bs(0)
    bs_v = bs_v_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 3, 1)
    # -> [mbh, mbw, line4(y), edge? ] careful: want [mbh,mbw,edge(x),line(y)]
    bs_v = bs_v_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 3, 1)
    bs_h = bs_h_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 1, 3)
    return bs_v, bs_h


def compute_strengths_b(nnz4, use0_mb, use1_mb, mv0_mb, mv1_mb,
                        *, mbw, mbh):
    """Boundary strengths for a B frame with 16x16 partitions (spec
    8.7.2.1 mixed-prediction rules; reference deblock_strength_c,
    deblock.c:277).

    use0/use1 [mbh,mbw]: per-list reference usage (covers explicit
    L0/L1/BI and direct MBs alike). bs = 2 on nnz edges; else 1 when
    the blocks use different reference sets or, with the same set, when
    any used list's |mv delta| >= 4; else 0. (Our two refs are distinct
    pictures, so no cross-list swap case arises.)"""
    ih, iw = mbh * 4, mbw * 4

    def rep4(a):
        return jnp.repeat(jnp.repeat(a, 4, axis=0), 4, axis=1)

    use04 = rep4(use0_mb)
    use14 = rep4(use1_mb)
    mv04 = rep4(mv0_mb)
    mv14 = rep4(mv1_mb)

    def edge_bs(axis):
        def shift(a):
            if axis == 1:
                pad = ((0, 0), (1, 0)) + ((0, 0),) * (a.ndim - 2)
                return jnp.pad(a, pad)[:, :-1]
            pad = ((1, 0), (0, 0)) + ((0, 0),) * (a.ndim - 2)
            return jnp.pad(a, pad)[:-1]

        nnz_p = shift(nnz4)
        u0_p = shift(use04)
        u1_p = shift(use14)
        mv0_p = shift(mv04)
        mv1_p = shift(mv14)
        nz = (nnz4 > 0) | (nnz_p > 0)
        diff_set = (use04 != u0_p) | (use14 != u1_p)
        d0 = jnp.any(jnp.abs(mv04 - mv0_p) >= 4, axis=-1)
        d1 = jnp.any(jnp.abs(mv14 - mv1_p) >= 4, axis=-1)
        mv_diff = (use04 & d0) | (use14 & d1)
        return jnp.where(nz, 2,
                         jnp.where(diff_set | mv_diff, 1, 0))

    bs_v_grid = edge_bs(1)
    bs_h_grid = edge_bs(0)
    bs_v = bs_v_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 3, 1)
    bs_h = bs_h_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 1, 3)
    return bs_v, bs_h


def _lut(table, idx):
    """Small-table lookup as a dense one-hot sum (a 52-entry
    compare+select+sum instead of a gather — same idiom as
    entropy/cavlc_jax.lut)."""
    t = np.asarray(table).reshape(-1)
    tj = jnp.asarray(t)
    ar = jnp.arange(t.shape[0], dtype=idx.dtype)
    return jnp.sum(jnp.where(idx[..., None] == ar, tj, 0), axis=-1)


def _edge_params(qp_avg, a_off, b_off, bs):
    """alpha/beta/tc0 for an edge given averaged qp (arrays)."""
    ia = jnp.clip(qp_avg + a_off, 0, 51).astype(jnp.int32)
    ib = jnp.clip(qp_avg + b_off, 0, 51).astype(jnp.int32)
    alpha = _lut(ALPHA_TABLE, ia)
    beta = _lut(BETA_TABLE, ib)
    tc0 = _lut(TC0_TABLE, ia * 3 + jnp.clip(bs, 1, 3) - 1)
    return alpha, beta, tc0


@partial(jax.jit, static_argnames=("mbw", "mbh", "a_off", "b_off",
                                   "chroma_qp_offset"))
def deblock_frame(y, u, v, bs_v, bs_h, qp_mb, *, mbw, mbh, a_off=0, b_off=0,
                  chroma_qp_offset=0):
    """Wavefront deblock of a full frame in SKEWED layout (ops/skew.py):
    each diagonal step is static dynamic-slice work — no gathers/scatters.

    In-step order is V edges then H edges across the whole diagonal, which
    reproduces the spec's raster MB order exactly: V(x,y) needs left MB
    final (step d-1 + same-step-earlier H write-back), H(x,y) needs V(x,y)
    and the top MB (V of (x+1,y-1) runs in this step's V phase, before H).
    Returns filtered (y, u, v)."""
    from . import skew
    H, W = y.shape
    Hc = H // 2
    D = skew.n_diags(mbw, mbh)
    cqp_tab = jnp.asarray(T.CHROMA_QP_TABLE)

    # --- boundary masking baked into the strength arrays ---
    bs_v = bs_v.at[:, 0, 0, :].set(0)       # picture left edge
    bs_h = bs_h.at[0, :, 0, :].set(0)       # picture top edge
    bsv_sk = skew.skew_mb(bs_v)             # [mbh, D+1, 4, 4]
    bsh_sk = skew.skew_mb(bs_h)
    qp_sk = skew.skew_mb(qp_mb)             # [mbh, D+1]
    cqp_mb = cqp_tab[jnp.clip(qp_mb + chroma_qp_offset, 0, 51)]
    cqp_sk = skew.skew_mb(cqp_mb)

    ys = skew.skew_plane(y.astype(jnp.int16), 16)           # [H, (D+1)*16]
    us = skew.skew_plane(u.astype(jnp.int16), 8)
    vs = skew.skew_plane(v.astype(jnp.int16), 8)
    cs = jnp.stack([us, vs])                                 # [2, Hc, ...]

    def step(carry, d):
        ys, cs = carry
        win = jax.lax.dynamic_slice(ys, (0, d * 16), (H, 32)) \
            .reshape(mbh, 16, 32)
        cwin = jax.lax.dynamic_slice(cs, (0, 0, d * 8), (2, Hc, 16)) \
            .reshape(2, mbh, 8, 16)
        qwin = jax.lax.dynamic_slice(qp_sk, (0, d), (mbh, 2))
        q_left, q_cur = qwin[:, 0], qwin[:, 1]
        q_top = jnp.concatenate([q_left[:1], q_left[:-1]])
        cqwin = jax.lax.dynamic_slice(cqp_sk, (0, d), (mbh, 2))
        cq_left, cq_cur = cqwin[:, 0], cqwin[:, 1]
        cq_top = jnp.concatenate([cq_left[:1], cq_left[:-1]])
        bsv = jax.lax.dynamic_slice(bsv_sk, (0, d + 1, 0, 0),
                                    (mbh, 1, 4, 4))[:, 0]    # [mbh,4,4]
        bsh = jax.lax.dynamic_slice(bsh_sk, (0, d + 1, 0, 0),
                                    (mbh, 1, 4, 4))[:, 0]

        # ---------------- luma V edges (left -> right) ----------------
        for e in range(4):
            qp_p = q_left if e == 0 else q_cur
            qp_av = (qp_p + q_cur + 1) >> 1
            bs_line = jnp.repeat(bsv[:, e], 4, axis=1)       # [mbh, 16]
            alpha, beta, tc0 = _edge_params(qp_av[:, None], a_off, b_off,
                                            bs_line)
            c = 16 + 4 * e
            p, q = filter_lines_luma(win[:, :, c - 4:c], win[:, :, c:c + 4],
                                     bs_line, alpha, beta, tc0)
            p = p.astype(win.dtype)
            q = q.astype(win.dtype)
            win = jnp.concatenate(
                [win[:, :, :c - 4], p, q, win[:, :, c + 4:]], axis=2)

        # ---------------- luma H edges (top -> bottom) ----------------
        # edge 0: q = current MB rows 0-3; p = TOP MB (strip d-1, lane y-1)
        # rows 12-15 — the previous lane's LEFT half.
        prev = jnp.concatenate([jnp.zeros_like(win[:1]), win[:-1]], axis=0)
        p_blk = prev[:, 12:16, 0:16].swapaxes(1, 2)          # [mbh,16,4]
        q_blk = win[:, 0:4, 16:32].swapaxes(1, 2)
        qp_av = (q_top + q_cur + 1) >> 1
        bs_line = jnp.repeat(bsh[:, 0], 4, axis=1)
        alpha, beta, tc0 = _edge_params(qp_av[:, None], a_off, b_off,
                                        bs_line)
        pf, qf = filter_lines_luma(p_blk, q_blk, bs_line, alpha, beta, tc0)
        pf = pf.astype(win.dtype)
        qf = qf.astype(win.dtype)
        pf = pf.swapaxes(1, 2)                               # [mbh,4,16]
        qf = qf.swapaxes(1, 2)
        # write pf back into NEXT-lane-minus-one's region: lane y's pf
        # belongs at lane y-1 rows 12:16 cols 0:16
        pf_sh = jnp.concatenate([pf[1:], win[mbh - 1:, 12:16, 0:16]], axis=0)
        left_half = jnp.concatenate([win[:, :12, 0:16], pf_sh], axis=1)
        right_half = jnp.concatenate([qf, win[:, 4:, 16:32]], axis=1)
        win = jnp.concatenate([left_half, right_half], axis=2)
        for e in range(1, 4):
            r = 4 * e
            qp_av = q_cur
            bs_line = jnp.repeat(bsh[:, e], 4, axis=1)
            alpha, beta, tc0 = _edge_params(qp_av[:, None], a_off, b_off,
                                            bs_line)
            p_blk = win[:, r - 4:r, 16:32].swapaxes(1, 2)
            q_blk = win[:, r:r + 4, 16:32].swapaxes(1, 2)
            pf, qf = filter_lines_luma(p_blk, q_blk, bs_line, alpha, beta,
                                       tc0)
            pf = pf.astype(win.dtype)
            qf = qf.astype(win.dtype)
            right = jnp.concatenate(
                [win[:, :r - 4, 16:32], pf.swapaxes(1, 2),
                 qf.swapaxes(1, 2), win[:, r + 4:, 16:32]], axis=1)
            win = jnp.concatenate([win[:, :, 0:16], right], axis=2)

        # ---------------- chroma (u and v batched) ----------------
        # V edges: chroma cols 0 (MB edge, luma e0) and 4 (luma e2)
        for ei, e in enumerate((0, 2)):
            cq_p = cq_left if e == 0 else cq_cur
            cqp = (cq_p + cq_cur + 1) >> 1                   # [mbh]
            bs_line = jnp.repeat(bsv[:, e], 2, axis=1)       # [mbh, 8]
            alpha, beta, tc0 = _edge_params(cqp[:, None], a_off, b_off,
                                            bs_line)
            c = 8 + 4 * ei
            pf, qf = filter_lines_chroma(
                cwin[:, :, :, c - 2:c], cwin[:, :, :, c:c + 2],
                bs_line[None], alpha[None], beta[None], tc0[None])
            pf = pf.astype(cwin.dtype)
            qf = qf.astype(cwin.dtype)
            cwin = jnp.concatenate(
                [cwin[:, :, :, :c - 2], pf, qf, cwin[:, :, :, c + 2:]],
                axis=3)
        # H edge 0: p = prev lane rows 6-7 LEFT half
        cprev = jnp.concatenate([jnp.zeros_like(cwin[:, :1]), cwin[:, :-1]],
                                axis=1)
        p_blk = cprev[:, :, 6:8, 0:8].swapaxes(2, 3)         # [2,mbh,8,2]
        q_blk = cwin[:, :, 0:2, 8:16].swapaxes(2, 3)
        cqp = (cq_top + cq_cur + 1) >> 1
        bs_line = jnp.repeat(bsh[:, 0], 2, axis=1)
        alpha, beta, tc0 = _edge_params(cqp[:, None], a_off, b_off, bs_line)
        pf, qf = filter_lines_chroma(p_blk, q_blk, bs_line[None],
                                     alpha[None], beta[None], tc0[None])
        pf = pf.astype(cwin.dtype)
        qf = qf.astype(cwin.dtype)
        pf = pf.swapaxes(2, 3)
        qf = qf.swapaxes(2, 3)
        pf_sh = jnp.concatenate([pf[:, 1:], cwin[:, mbh - 1:, 6:8, 0:8]],
                                axis=1)
        lh = jnp.concatenate([cwin[:, :, :6, 0:8], pf_sh], axis=2)
        rh = jnp.concatenate([qf, cwin[:, :, 2:, 8:16]], axis=2)
        cwin = jnp.concatenate([lh, rh], axis=3)
        # H internal edge (chroma row 4, luma e2)
        bs_line = jnp.repeat(bsh[:, 2], 2, axis=1)
        alpha, beta, tc0 = _edge_params(cq_cur[:, None], a_off, b_off,
                                        bs_line)
        p_blk = cwin[:, :, 2:4, 8:16].swapaxes(2, 3)
        q_blk = cwin[:, :, 4:6, 8:16].swapaxes(2, 3)
        pf, qf = filter_lines_chroma(p_blk, q_blk, bs_line[None],
                                     alpha[None], beta[None], tc0[None])
        pf = pf.astype(cwin.dtype)
        qf = qf.astype(cwin.dtype)
        rh = jnp.concatenate([cwin[:, :, :2, 8:16], pf.swapaxes(2, 3),
                              qf.swapaxes(2, 3), cwin[:, :, 6:, 8:16]],
                             axis=2)
        cwin = jnp.concatenate([cwin[:, :, :, 0:8], rh], axis=3)

        ys = jax.lax.dynamic_update_slice(ys, win.reshape(H, 32),
                                          (0, d * 16))
        cs = jax.lax.dynamic_update_slice(cs, cwin.reshape(2, Hc, 16),
                                          (0, 0, d * 8))
        return (ys, cs), None

    (ys, cs), _ = jax.lax.scan(step, (ys, cs),
                               jnp.arange(D, dtype=jnp.int32))
    yo = skew.unskew_plane(ys, 16, mbw).astype(jnp.uint8)
    uo = skew.unskew_plane(cs[0], 8, mbw).astype(jnp.uint8)
    vo = skew.unskew_plane(cs[1], 8, mbw).astype(jnp.uint8)
    return yo, uo, vo


@partial(jax.jit, static_argnames=("mbw", "mbh", "a_off", "b_off"))
def deblock_frame_gather(y, u, v, bs_v, bs_h, qp_mb, sched_x, sched_y,
                         sched_valid, *, mbw, mbh, a_off=0, b_off=0,
                         chroma_qp_offset=0):
    """Gather/scatter wavefront deblock (reference twin for tests)."""
    H, W = y.shape
    yf = y.astype(jnp.int32)
    uf = u.astype(jnp.int32)
    vf = v.astype(jnp.int32)
    cqp_tab = jnp.asarray(T.CHROMA_QP_TABLE)

    ar16 = jnp.arange(16, dtype=jnp.int32)
    ar20 = jnp.arange(20, dtype=jnp.int32)
    ar8 = jnp.arange(8, dtype=jnp.int32)
    ar12 = jnp.arange(12, dtype=jnp.int32)

    def qp_of(mbx, mby):
        return qp_mb[jnp.clip(mby, 0, mbh - 1), jnp.clip(mbx, 0, mbw - 1)]

    def step(carry, xs):
        yp, up, vp = carry
        mbx, mby, valid = xs
        L = mbx.shape[0]
        qp_q = qp_of(mbx, mby)
        qp_left = qp_of(mbx - 1, mby)
        qp_top = qp_of(mbx, mby - 1)
        bsv = bs_v[mby, mbx]            # [L, 4, 4] edge x line
        bsh = bs_h[mby, mbx]
        # picture-boundary edges off
        bsv = bsv.at[:, 0].set(jnp.where((mbx > 0)[:, None], bsv[:, 0], 0))
        bsh = bsh.at[:, 0].set(jnp.where((mby > 0)[:, None], bsh[:, 0], 0))

        # ================= luma =================
        # --- vertical edges: region [L, 16, 20] cols x0-4 .. x0+15 ---
        x0 = mbx * 16
        y0 = mby * 16
        rows = jnp.clip(y0[:, None, None] + ar16[None, :, None], 0, H - 1)
        cols = jnp.clip(x0[:, None, None] - 4 + ar20[None, None, :],
                        0, W - 1)
        reg = yp[rows, cols]                     # [L,16,20]
        for e in range(4):
            qp_p = qp_left if e == 0 else qp_q
            qp_av = (qp_p + qp_q + 1) >> 1
            bs_line = jnp.repeat(bsv[:, e], 4, axis=1)      # [L,16]
            alpha, beta, tc0 = _edge_params(qp_av[:, None], a_off, b_off,
                                            bs_line)
            c = 4 + 4 * e
            pside, qside = filter_lines_luma(
                reg[:, :, c - 4:c], reg[:, :, c:c + 4],
                bs_line, alpha, beta, tc0)
            reg = jnp.concatenate(
                [reg[:, :, :c - 4], pside, qside, reg[:, :, c + 4:]],
                axis=2)
        wcols = jnp.where(valid[:, None, None], cols, W + 999)
        yp = yp.at[rows, wcols].set(reg, mode="drop")

        # --- horizontal edges: region [L, 20, 16] rows y0-4..y0+15 ---
        rows2 = jnp.clip(y0[:, None, None] - 4 + ar20[None, :, None],
                         0, H - 1)
        cols2 = jnp.clip(x0[:, None, None] + ar16[None, None, :], 0, W - 1)
        reg = yp[rows2, cols2]
        for e in range(4):
            qp_p = qp_top if e == 0 else qp_q
            qp_av = (qp_p + qp_q + 1) >> 1
            bs_line = jnp.repeat(bsh[:, e], 4, axis=1)
            alpha, beta, tc0 = _edge_params(qp_av[:, None], a_off, b_off,
                                            bs_line)
            r = 4 + 4 * e
            pside = reg[:, r - 4:r].swapaxes(1, 2)       # [L,16,4]
            qside = reg[:, r:r + 4].swapaxes(1, 2)
            pf, qf = filter_lines_luma(pside, qside, bs_line, alpha, beta,
                                       tc0)
            reg = jnp.concatenate(
                [reg[:, :r - 4], pf.swapaxes(1, 2), qf.swapaxes(1, 2),
                 reg[:, r + 4:]], axis=1)
        wrows2 = jnp.where(valid[:, None, None], rows2, H + 999)
        yp = yp.at[wrows2, cols2].set(reg, mode="drop")

        # ================= chroma (4:2:0): edges at luma 0 and 8 =========
        cx0 = mbx * 8
        cy0 = mby * 8
        Hc, Wc = H // 2, W // 2
        for plane_idx in range(2):
            pl = up if plane_idx == 0 else vp
            # vertical: region [L, 8, 12] cols cx0-2? need p1,p0|q0,q1:
            # 2 px each side; region cols cx0-2..cx0+9? edges at 0 and 4:
            # cols: use 12 wide from cx0-2
            rowsc = jnp.clip(cy0[:, None, None] + ar8[None, :, None],
                             0, Hc - 1)
            colsc = jnp.clip(cx0[:, None, None] - 2 + ar12[None, None, :],
                             0, Wc - 1)
            regc = pl[rowsc, colsc]                 # [L,8,12]
            for ei, e in enumerate((0, 2)):          # luma edges 0, 8
                qp_p = qp_left if e == 0 else qp_q
                # spec 8.7.2.2: average of the two CHROMA qps
                cqp_p = cqp_tab[jnp.clip(qp_p + chroma_qp_offset, 0, 51)]
                cqp_q = cqp_tab[jnp.clip(qp_q + chroma_qp_offset, 0, 51)]
                cqp = (cqp_p + cqp_q + 1) >> 1
                bs_line = jnp.repeat(bsv[:, e], 2, axis=1)   # [L,8]
                alpha, beta, tc0 = _edge_params(cqp[:, None], a_off, b_off,
                                                bs_line)
                c = 2 + 4 * ei
                pf, qf = filter_lines_chroma(
                    regc[:, :, c - 2:c], regc[:, :, c:c + 2],
                    bs_line, alpha, beta, tc0)
                regc = jnp.concatenate(
                    [regc[:, :, :c - 2], pf, qf, regc[:, :, c + 2:]],
                    axis=2)
            wcolsc = jnp.where(valid[:, None, None], colsc, Wc + 999)
            pl = pl.at[rowsc, wcolsc].set(regc, mode="drop")
            # horizontal
            rowsc2 = jnp.clip(cy0[:, None, None] - 2 + ar12[None, :, None],
                              0, Hc - 1)
            colsc2 = jnp.clip(cx0[:, None, None] + ar8[None, None, :],
                              0, Wc - 1)
            regc = pl[rowsc2, colsc2]               # [L,12,8]
            for ei, e in enumerate((0, 2)):
                qp_p = qp_top if e == 0 else qp_q
                cqp_p = cqp_tab[jnp.clip(qp_p + chroma_qp_offset, 0, 51)]
                cqp_q = cqp_tab[jnp.clip(qp_q + chroma_qp_offset, 0, 51)]
                cqp = (cqp_p + cqp_q + 1) >> 1
                bs_line = jnp.repeat(bsh[:, e], 2, axis=1)
                alpha, beta, tc0 = _edge_params(cqp[:, None], a_off, b_off,
                                                bs_line)
                r = 2 + 4 * ei
                pside = regc[:, r - 2:r].swapaxes(1, 2)
                qside = regc[:, r:r + 2].swapaxes(1, 2)
                pf, qf = filter_lines_chroma(pside, qside, bs_line, alpha,
                                             beta, tc0)
                regc = jnp.concatenate(
                    [regc[:, :r - 2], pf.swapaxes(1, 2), qf.swapaxes(1, 2),
                     regc[:, r + 2:]], axis=1)
            wrowsc2 = jnp.where(valid[:, None, None], rowsc2, Hc + 999)
            pl = pl.at[wrowsc2, colsc2].set(regc, mode="drop")
            if plane_idx == 0:
                up = pl
            else:
                vp = pl
        return (yp, up, vp), None

    (yf, uf, vf), _ = jax.lax.scan(step, (yf, uf, vf),
                                   (sched_x, sched_y, sched_valid))
    return (yf.astype(jnp.uint8), uf.astype(jnp.uint8),
            vf.astype(jnp.uint8))
