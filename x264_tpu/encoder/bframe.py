"""B-frame encoding: bidirectional prediction with per-MB list choice.

Reference analogues: mb_analyse_inter_b16x16 / b_direct handling
(analyse.c:1844-2545), B MVP (common/mvpred.c:30 with per-list reference
matching), spatial direct (mvpred.c:290), B entropy (cavlc.c:487 B
branches). Batched form: both reference directions run the same
batched ESA + fused subpel pipeline as P frames; the per-MB mode
(L0 / L1 / BI) is an argmin over three cost planes; B_Direct_16x16 is
derived spatially from the decided fields and adopted through a bounded
fixed-point loop (encoder/bdirect.py) so the final coded fields are
self-consistent with the decoder's own derivation; B_Skip falls out as
direct + zero residual. The exact per-list MVP field is then computed in
one shift-based pass over the final mode/mv fields.

Scope: B_L0/L1/BI/Direct_16x16 + B_Skip, CAVLC+CABAC, non-reference B
(no pyramid), 1 ref per list.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..entropy import nal as nal_mod
from ..ops import dct, mc, quant
from ..ops.tables import ZIGZAG4_FRAME, chroma_qp
from .bdirect import derive_direct, direct_pred_luma
from .intra import _chroma_blocks, _chroma_merge, _luma_blocks, \
    _luma_merge, _mb_tiles, cap_bytes_per_mb
from .inter import (_decimate_score, _satd16, chroma_mc_warp, motion_search,
                    subpel_refine_mc)

MODE_L0, MODE_L1, MODE_BI, MODE_DIRECT = 0, 1, 2, 3


def implicit_weights(poc_cur: int, poc_l0: int, poc_l1: int):
    """Implicit weighted bipred (w0, w1) from POC distances (spec
    8.4.2.3.2; reference mb.bipred_weight init, macroblock.c:1883).
    Default (32, 32) when the scale is out of range."""
    tb = max(-128, min(127, poc_cur - poc_l0))
    td = max(-128, min(127, poc_l1 - poc_l0))
    if td == 0:
        return 32, 32
    tx = (16384 + abs(td >> 1)) // td
    dsf = max(-1024, min(1023, (tb * tx + 32) >> 6))
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def mv_predictors_b(mv_field, use_mask):
    """Per-list median MVP for 16x16 B partitions (spec 8.4.1.3).

    mv_field [mbh, mbw, 2]: the list-X MV of each MB (garbage where the
    list is unused). use_mask [mbh, mbw] bool: MB uses list X.
    Neighbors that do not use list X contribute mv 0 / refIdx -1; if
    exactly one neighbor matches the reference, its MV is the predictor.
    Returns mvp [mbh, mbw, 2]."""
    mbh, mbw = use_mask.shape
    zeros2 = jnp.zeros_like(mv_field)

    def shift_left(a):
        return jnp.concatenate([jnp.zeros_like(a[:, :1]), a[:, :-1]],
                               axis=1)

    def shift_up(a):
        return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)

    def shift_upright(a):
        up = shift_up(a)
        return jnp.concatenate([up[:, 1:], jnp.zeros_like(up[:, :1])],
                               axis=1)

    def shift_upleft(a):
        return shift_left(shift_up(a))

    col = jnp.arange(mbw)[None, :]
    row = jnp.arange(mbh)[:, None]
    avail_a = jnp.broadcast_to(col > 0, (mbh, mbw))
    avail_b = jnp.broadcast_to(row > 0, (mbh, mbw))
    avail_c0 = avail_b & (col < mbw - 1)
    avail_d = avail_a & avail_b

    mv_a = jnp.where(avail_a[..., None], shift_left(mv_field), 0)
    mv_b = jnp.where(avail_b[..., None], shift_up(mv_field), 0)
    use_a = avail_a & shift_left(use_mask)
    use_b = avail_b & shift_up(use_mask)
    # C with D fallback when C unavailable (spec 8.4.1.3.2)
    mv_c = jnp.where(avail_c0[..., None], shift_upright(mv_field),
                     jnp.where(avail_d[..., None],
                               shift_upleft(mv_field), 0))
    use_c = jnp.where(avail_c0, shift_upright(use_mask),
                      avail_d & shift_upleft(use_mask))
    avail_c = avail_c0 | avail_d

    # contributions: matching neighbors keep their mv, others are zero
    ca = jnp.where(use_a[..., None], mv_a, zeros2)
    cb = jnp.where(use_b[..., None], mv_b, zeros2)
    cc = jnp.where(use_c[..., None], mv_c, zeros2)
    nmatch = (use_a.astype(jnp.int32) + use_b.astype(jnp.int32)
              + use_c.astype(jnp.int32))
    only = jnp.where(use_a[..., None], ca,
                     jnp.where(use_b[..., None], cb, cc))
    med = jnp.median(jnp.stack([ca, cb, cc]), axis=0).astype(jnp.int32)
    mvp = jnp.where((nmatch == 1)[..., None], only, med)
    # early rule: only A of B/C available -> A's value regardless of match
    early = avail_a & ~avail_b & ~avail_c
    mvp = jnp.where(early[..., None], mv_a, mvp)
    return mvp


@partial(jax.jit, static_argnames=("mbw", "mbh", "cap_words", "me_range",
                                   "deblock", "a_off", "b_off", "cqpo",
                                   "decimate", "entropy", "use_direct",
                                   "trellis"))
def encode_bframe_device(y, u, v, r0_y, r0_hpel, r0_cuv, r1_y, r1_hpel,
                         r1_cuv, qp_mb, qpc_mb, slice_qp, lam, w0, w1,
                         col_inter, col_mv, col_uniform,
                         *, mbw, mbh, cap_words, me_range, deblock=False,
                         a_off=0, b_off=0, cqpo=0, decimate=True,
                         entropy=True, use_direct=True, trellis=False,
                         trl_tabs=None):
    """Fused B-frame device pass. Returns (words, total_bits, recon,
    stats). (w0, w1) are the implicit bipred weights (traced scalars so
    POC-distance changes do not recompile). col_inter/col_mv are the L1
    anchor's colocated inter mask + MV field for spatial direct;
    col_uniform [mbh,mbw] marks colocated MBs whose four 8x8-quadrant
    corner cells (direct_8x8_inference, spec 8.4.1.2.2) agree on
    colZeroFlag — direct/skip is only chosen there, so the whole-MB
    derivation below equals the decoder's per-quadrant one."""
    from ..entropy.cavlc_jax import encode_bframe_entropy_dev
    H, W = y.shape
    n = mbw * mbh

    def bipred(p0, p1):
        return jnp.clip((p0 * w0 + p1 * w1 + 32) >> 6, 0, 255)

    preds, mvs = [], []
    for ry, rh in ((r0_y, r0_hpel), (r1_y, r1_hpel)):
        mv_c = motion_search(ry, rh, y, lam, me_range)
        mvq, pred, _ = subpel_refine_mc(rh, y, mv_c, lam, me_range)
        preds.append(pred)
        mvs.append(mvq)
    tiles = _mb_tiles(y, 16).reshape(n, 16, 16)
    pred_bi = bipred(preds[0], preds[1])
    c0 = _satd16(preds[0], tiles)
    c1 = _satd16(preds[1], tiles)
    cbi = _satd16(pred_bi, tiles) + lam * 3   # small bits bias for 2 MVs
    mode = jnp.argmin(jnp.stack([c0, c1, cbi]), axis=0).astype(jnp.int32)
    best_exp = jnp.minimum(jnp.minimum(c0, c1), cbi)
    pred_y = jnp.where((mode == MODE_L0)[:, None, None], preds[0],
                       jnp.where((mode == MODE_L1)[:, None, None],
                                 preds[1], pred_bi))

    # explicit per-list fields (cache convention: mv 0 where unused)
    mode_f = mode.reshape(mbh, mbw)
    use0_e = mode_f != MODE_L1
    use1_e = mode_f != MODE_L0
    mv0_e = jnp.where(use0_e[..., None], mvs[0].reshape(mbh, mbw, 2), 0)
    mv1_e = jnp.where(use1_e[..., None], mvs[1].reshape(mbh, mbw, 2), 0)

    if use_direct:
        # ---- spatial direct (bdirect.py): derive from the explicit
        # fields, adopt where cheaper, then shrink to a fixed point so
        # the decoder's derivation from the coded fields reproduces the
        # exact MVs used here ----
        du0, du1, dm0, dm1 = derive_direct(use0_e, use1_e, mv0_e, mv1_e,
                                           col_inter, col_mv)
        bound = 4 * (me_range - 1)
        valid = (jnp.max(jnp.abs(dm0), axis=-1) <= bound) \
            & (jnp.max(jnp.abs(dm1), axis=-1) <= bound)
        dm0f = dm0.reshape(n, 2)
        dm1f = dm1.reshape(n, 2)
        pd0 = direct_pred_luma(r0_hpel, dm0f, mbh, mbw)
        pd1 = direct_pred_luma(r1_hpel, dm1f, mbh, mbw)
        du0f = du0.reshape(n)
        du1f = du1.reshape(n)
        pred_dir = jnp.where((du0f & du1f)[:, None, None],
                             bipred(pd0, pd1),
                             jnp.where(du0f[:, None, None], pd0, pd1))
        cost_dir = _satd16(pred_dir, tiles)
        is_dir = valid & col_uniform \
            & (cost_dir <= best_exp).reshape(mbh, mbw)

        def fields_of(isd):
            i3 = isd[..., None]
            return (jnp.where(isd, du0, use0_e),
                    jnp.where(isd, du1, use1_e),
                    jnp.where(i3, dm0, mv0_e),
                    jnp.where(i3, dm1, mv1_e))

        def cond(carry):
            _, changed = carry
            return changed

        def body(carry):
            isd, _ = carry
            f0, f1, m0, m1 = fields_of(isd)
            nd0, nd1, nm0, nm1 = derive_direct(f0, f1, m0, m1,
                                               col_inter, col_mv)
            match = ((nd0 == du0) & (nd1 == du1)
                     & jnp.all(nm0 == dm0, axis=-1)
                     & jnp.all(nm1 == dm1, axis=-1))
            new = isd & match
            return (new, jnp.any(new != isd))

        is_dir, _ = jax.lax.while_loop(cond, body,
                                       (is_dir, jnp.asarray(True)))
        use0_f, use1_f, mv0_f, mv1_f = fields_of(is_dir)
        is_dir_flat = is_dir.reshape(n)
        mode = jnp.where(is_dir_flat, MODE_DIRECT, mode)
        mode_f = mode.reshape(mbh, mbw)
        pred_y = jnp.where(is_dir_flat[:, None, None], pred_dir, pred_y)
    else:
        use0_f, use1_f, mv0_f, mv1_f = use0_e, use1_e, mv0_e, mv1_e
        is_dir_flat = jnp.zeros((n,), bool)

    # per-list MVP over the decided fields (no recon dependency)
    mvp0 = mv_predictors_b(mv0_f, use0_f)
    mvp1 = mv_predictors_b(mv1_f, use1_f)
    mvd0 = (mv0_f - mvp0).reshape(n, 2)
    mvd1 = (mv1_f - mvp1).reshape(n, 2)

    # --- transform (same as P) ---
    qp = qp_mb.reshape(-1)
    res = tiles.astype(jnp.int32) - pred_y
    blocks = _luma_blocks(res)
    w = dct.dct4x4(blocks)
    lv = quant.quant4x4(w, qp[:, None], intra=False)
    if trellis:
        # RD-optimal requantization (rdo.c:642), same batched Viterbi
        # as the P path
        from ..ops.trellis import trellis_4x4
        sig_c, last_c, lvl_s = trl_tabs
        out_z, _ = trellis_4x4(dct.zigzag4(lv).reshape(n * 16, 16),
                               dct.zigzag4(w).reshape(n * 16, 16),
                               jnp.repeat(qp, 16), sig_c, last_c, lvl_s)
        lv = dct.izigzag4(out_z).reshape(n, 16, 4, 4)

    # --- chroma: MC per list then combine by mode ---
    qpc = qpc_mb.reshape(-1)
    pc0 = chroma_mc_warp(r0_cuv, mvs[0], mbh, mbw)
    pc1 = chroma_mc_warp(r1_cuv, mvs[1], mbh, mbw)
    pcbi = bipred(pc0, pc1)
    pred_c_all = jnp.where((mode == MODE_L0)[:, None, None, None], pc0,
                           jnp.where((mode == MODE_L1)[:, None, None,
                                                       None], pc1, pcbi))
    if use_direct:
        pcd0 = chroma_mc_warp(r0_cuv, mv0_f.reshape(n, 2), mbh, mbw)
        pcd1 = chroma_mc_warp(r1_cuv, mv1_f.reshape(n, 2), mbh, mbw)
        du0f = use0_f.reshape(n)
        du1f = use1_f.reshape(n)
        pred_c_dir = jnp.where((du0f & du1f)[:, None, None, None],
                               bipred(pcd0, pcd1),
                               jnp.where(du0f[:, None, None, None],
                                         pcd0, pcd1))
        pred_c_all = jnp.where(is_dir_flat[:, None, None, None],
                               pred_c_dir, pred_c_all)
    out_c = []
    for ci, src_pl in enumerate((u, v)):
        pred_c = pred_c_all[:, ci]
        src_c = _mb_tiles(src_pl, 8).reshape(n, 8, 8)
        res_c = src_c.astype(jnp.int32) - pred_c
        cblocks = _chroma_blocks(res_c)
        wc = dct.dct4x4(cblocks)
        dcs = wc[:, :, 0, 0].reshape(-1, 2, 2)
        had = dct.hadamard2x2(dcs)
        dc_lv = quant.quant2x2_dc(had, qpc, intra=False)
        ac_lv = quant.quant4x4(wc, qpc[:, None], intra=False)
        ac_lv = ac_lv.at[:, :, 0, 0].set(0)
        f = dct.ihadamard2x2(dc_lv)
        dc_vals = quant.dequant2x2_dc(f, qpc)
        d = quant.dequant4x4(ac_lv, qpc[:, None])
        d = d.at[:, :, 0, 0].set(dc_vals.reshape(-1, 4))
        rec_c = jnp.clip(pred_c + _chroma_merge(dct.idct4x4(d)), 0, 255)
        out_c.append((dc_lv, ac_lv, rec_c))
    (udc, uac, urec), (vdc, vac, vrec) = out_c

    # --- decimation + luma recon (mirrors the P path) ---
    lv_z = dct.zigzag4(lv.reshape(n, 16, 4, 4))
    dec_score = _decimate_score(lv_z) if decimate else \
        jnp.full((n, 16), 99, jnp.int32)
    quad_of = jnp.asarray(
        np.array([(r // 2) * 2 + (c // 2) for r in range(4)
                  for c in range(4)], np.int32))
    qsum = jnp.zeros((n, 4), jnp.int32)
    for b in range(16):
        qsum = qsum.at[:, quad_of[b]].add(dec_score[:, b])
    mb_sum = jnp.sum(qsum, axis=1)
    keep_quad = (qsum >= 4) & (mb_sum >= 6)[:, None]
    keep_blk = keep_quad[:, quad_of]
    lv = jnp.where(keep_blk[:, :, None, None], lv.reshape(n, 16, 4, 4), 0)
    dq = quant.dequant4x4(lv, qp[:, None])
    recon_y_mb = jnp.clip(pred_y + _luma_merge(dct.idct4x4(dq)), 0, 255)

    nnz_l = jnp.sum(lv.reshape(n, 16, 16) != 0, axis=2)
    cbp_bits = []
    for qd in range(4):
        qy, qx = qd // 2, qd % 2
        idx = [(2 * qy + by) * 4 + (2 * qx + bx)
               for by in range(2) for bx in range(2)]
        qnnz = sum(nnz_l[:, i] for i in idx)
        cbp_bits.append((qnnz > 0).astype(jnp.int32) << qd)
    cbp_luma = sum(cbp_bits)
    any_cac = (jnp.sum(jnp.sum(uac.reshape(n, 4, 16) != 0, axis=2), axis=1)
               + jnp.sum(jnp.sum(vac.reshape(n, 4, 16) != 0, axis=2),
                         axis=1)) > 0
    any_cdc = (jnp.sum(udc.reshape(n, 4) != 0, axis=1)
               + jnp.sum(vdc.reshape(n, 4) != 0, axis=1)) > 0
    cbp_chroma = jnp.where(any_cac, 2, jnp.where(any_cdc, 1, 0))
    # B_Skip: direct prediction with no residual (analyse.c early skip)
    skip = is_dir_flat & (cbp_luma == 0) & (cbp_chroma == 0)
    if use_direct:
        satd_cost = jnp.sum(jnp.where(is_dir_flat, cost_dir, best_exp))
    else:
        satd_cost = jnp.sum(best_exp)

    def merge_plane(mb_tensor, s, hh, ww):
        return mb_tensor.reshape(hh // s, ww // s, s, s) \
            .swapaxes(1, 2).reshape(hh, ww)
    recon_y = merge_plane(recon_y_mb, 16, H, W).astype(jnp.uint8)
    recon_u = merge_plane(urec, 8, H // 2, W // 2).astype(jnp.uint8)
    recon_v = merge_plane(vrec, 8, H // 2, W // 2).astype(jnp.uint8)

    cdc_blk = jnp.stack([udc.reshape(n, 2, 2), vdc.reshape(n, 2, 2)],
                        axis=1)
    cac_blk = jnp.stack([uac.reshape(n, 4, 4, 4), vac.reshape(n, 4, 4, 4)],
                        axis=1)
    if entropy:
        words, total_bits, eff_qp = encode_bframe_entropy_dev(
            mode, mvd0, mvd1, cbp_luma, cbp_chroma, qp, slice_qp,
            lv.reshape(n, 16, 4, 4), cdc_blk, cac_blk,
            mbw=mbw, mbh=mbh, cap_words=cap_words, skip=skip)
    else:
        # decoder-carried QP (same rule as the CAVLC entropy stage)
        has_resid = ((cbp_luma > 0) | (cbp_chroma > 0)) & ~skip
        idxs = jnp.arange(n, dtype=jnp.int32)
        last_r = jax.lax.cummax(jnp.where(has_resid, idxs, -1))
        prev_r = jnp.concatenate([jnp.full((1,), -1, jnp.int32),
                                  last_r[:-1]])
        prev_qp = jnp.where(prev_r >= 0, qp[jnp.maximum(prev_r, 0)],
                            slice_qp)
        eff_qp = jnp.where(has_resid, qp, prev_qp)
        zig = jnp.asarray(ZIGZAG4_FRAME)
        decisions = {
            "mode": mode, "skip": skip, "mvd0": mvd0, "mvd1": mvd1,
            "cbp_luma": cbp_luma, "cbp_chroma": cbp_chroma, "qp": qp,
            "luma_z": lv.reshape(n, 16, 16)[:, :, zig],
            "cdc": cdc_blk.reshape(n, 2, 4),
            "cac_z": cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig],
        }
        words, total_bits = decisions, None
    if deblock:
        from ..ops.deblock import compute_strengths_b, deblock_frame
        nnz4 = nnz_l.reshape(mbh, mbw, 4, 4).transpose(0, 2, 1, 3) \
            .reshape(mbh * 4, mbw * 4).astype(jnp.int32)
        bs_v, bs_h = compute_strengths_b(
            nnz4, use0_f, use1_f, mv0_f, mv1_f, mbw=mbw, mbh=mbh)
        recon_y, recon_u, recon_v = deblock_frame(
            recon_y, recon_u, recon_v, bs_v, bs_h,
            eff_qp.reshape(mbh, mbw), mbw=mbw, mbh=mbh,
            a_off=a_off, b_off=b_off, chroma_qp_offset=cqpo)
    stats = {"satd": satd_cost, "skip": jnp.sum(skip),
             "direct": jnp.sum(is_dir_flat)}
    return words, total_bits, (recon_y, recon_u, recon_v), stats


def cabac_finalize_bframe(enc, decisions, qp_mb, slice_qp, sh):
    """Host tail of a CABAC B frame (native/cabac.cpp B writer)."""
    from ..entropy.cabac_host import encode_slice_cabac
    from ..entropy.cavlc import LUMA4x4_RASTER
    from .intra import finalize_slice_cabac
    mbw, mbh = enc.mb_w, enc.mb_h
    n = mbw * mbh
    d = {k: np.asarray(val) for k, val in decisions.items()}
    luma = d["luma_z"].astype(np.int16)[:, LUMA4x4_RASTER]
    payload = encode_slice_cabac(
        1, mbw, mbh, slice_qp,
        d["skip"].astype(np.uint8), np.zeros(n, np.uint8),
        np.zeros(n, np.uint8), np.zeros(n, np.uint8),
        d["cbp_luma"], d["cbp_chroma"], np.asarray(qp_mb).reshape(-1),
        d["mvd0"].astype(np.int16),
        np.zeros((n, 16), np.int16), luma,
        d["cdc"].astype(np.int16), d["cac_z"].reshape(n, 8, 16),
        model=0, bmode=d["mode"], mvd1=d["mvd1"].astype(np.int16))
    sh.cabac_init_idc = 0
    return finalize_slice_cabac(enc, payload, sh, nal_mod.NAL_SLICE,
                                nal_mod.NAL_PRIORITY_DISPOSABLE)


def dispatch_bframe(enc, planes, qp, ref_fwd_tag, ref_bwd_tag):
    """Device dispatch of one non-reference B frame.
    Returns (finalize_fn, retry_fn, recon_dev=None, ref_tag)."""
    from .encoder import TYPE_B
    from .frame_encode import build_qp_maps
    from .intra import PayloadOverflow, finalize_slice  # noqa: F401
    mbw, mbh = enc.mb_w, enc.mb_h
    ref0 = next(r for r in enc._dpb if r["tag"] == ref_fwd_tag)
    ref1 = next(r for r in enc._dpb if r["tag"] == ref_bwd_tag)
    y, u, v = [jnp.asarray(p) for p in planes]
    me_range = min(enc.p.analyse.me_range, mc.PAD - 8)
    if enc.pps.weighted_bipred_idc == 2:
        w0, w1 = implicit_weights(enc.poc, ref0["poc"], ref1["poc"])
    else:
        w0, w1 = 32, 32
    w0 = jnp.asarray(w0, jnp.int32)
    w1 = jnp.asarray(w1, jnp.int32)
    use_direct = enc.p.analyse.direct_mv_pred != 0
    col_inter = ref1.get("inter_mask")
    col_mv = ref1.get("mvf")
    if col_inter is None or col_mv is None:
        col_inter = jnp.zeros((mbh, mbw), bool)
        col_mv = jnp.zeros((mbh, mbw, 2), jnp.int32)
        col_uniform = jnp.ones((mbh, mbw), bool)
    else:
        col_mv4 = ref1.get("mvf4")
        if col_mv4 is None:     # 16x16-only colocated: always uniform
            col_uniform = jnp.ones((mbh, mbw), bool)
        else:
            # quadrant corner cells (direct_8x8_inference): colZero must
            # agree across the 4 corners for whole-MB direct coding
            c4 = col_mv4.reshape(mbh, 4, mbw, 4, 2)
            corners = jnp.stack([c4[:, cy, :, cx] for cy, cx in
                                 ((0, 0), (0, 3), (3, 0), (3, 3))],
                                axis=2)                 # [mbh,mbw,4,2]
            cz = (jnp.abs(corners[..., 0]) <= 1) \
                & (jnp.abs(corners[..., 1]) <= 1)       # [mbh,mbw,4]
            col_uniform = jnp.all(cz == cz[..., :1], axis=-1)
    sh = enc._slice_header(TYPE_B, qp)
    materialize = (enc.p.analyse.psnr or enc.p.analyse.ssim
                   or enc.p.dump_yuv or enc.p.full_recon)

    def attempt(qp_try):
        qp_mb, qpc_mb = build_qp_maps(enc, y, u, v, qp_try)
        lam = max(1, int(round(2.0 ** ((qp_try - 12) / 6.0))))
        cap_words = (mbw * mbh * cap_bytes_per_mb(qp_try)) // 4
        use_trellis = bool(enc.p.analyse.trellis) and enc.p.cabac
        trl_tabs = None
        if use_trellis:
            from ..ops.trellis import frame_ctx_costs
            sig_c, last_c, lvl_s = frame_ctx_costs(False, qp_try, cat=2)
            trl_tabs = (jnp.asarray(sig_c), jnp.asarray(last_c),
                        jnp.asarray(lvl_s))
        words, total_bits, recon, stats = encode_bframe_device(
            y, u, v, ref0["y_pad"], ref0["hpel"], ref0["cuv_pad"],
            ref1["y_pad"], ref1["hpel"], ref1["cuv_pad"],
            qp_mb, qpc_mb, qp_try, lam, w0, w1, col_inter, col_mv,
            col_uniform,
            mbw=mbw, mbh=mbh, cap_words=cap_words, me_range=me_range,
            decimate=enc.p.analyse.dct_decimate,
            deblock=enc.p.deblocking_filter,
            a_off=enc.p.deblocking_filter_alphac0 * 2,
            b_off=enc.p.deblocking_filter_beta * 2,
            cqpo=enc.p.analyse.chroma_qp_offset,
            entropy=not enc.p.cabac, use_direct=use_direct,
            trellis=use_trellis, trl_tabs=trl_tabs)

        def finalize():
            sh.qp = qp_try
            if enc.p.cabac:
                nals = cabac_finalize_bframe(enc, words, qp_mb, qp_try,
                                             sh)
            else:
                nals = finalize_slice(enc, words, total_bits, cap_words,
                                      sh, nal_mod.NAL_SLICE,
                                      nal_mod.NAL_PRIORITY_DISPOSABLE)
            rec = [np.asarray(r) for r in recon] if materialize \
                else list(recon)
            enc.rc.end(TYPE_B, sum(len(n.payload) * 8 for n in nals),
                       float(stats["satd"]), qp_try)
            return nals, rec

        return finalize, None    # non-reference: no DPB entry

    finalize, _ = attempt(qp)
    return finalize, attempt, None, None
