"""Device-side CAVLC: code generation AND bit packing on the device.

The reference writes CAVLC serially through a host bit engine
(encoder/cavlc.c + bs_t). Here the entire MB-layer entropy stage is device
tensor code: per-block (code, length) syntax elements via vectorized table
gathers, then a two-scatter-add bit packer (each ≤32-bit element lands in at
most two consecutive 32-bit words of the output), so a frame's slice payload
leaves the chip as a few hundred KB of packed words instead of tens of MB of
coefficients. entropy/cavlc.py holds the numpy twin used as the golden
reference in tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tables import ZIGZAG4_FRAME
from . import vlc_tables as V
from .cavlc import LUMA4x4_RASTER

BLOCK_SLOTS = 36


def lut(table, idx):
    """Small-table lookup as a dense one-hot sum (compare+select+sum over
    the table axis instead of a gather). table is a numpy array (any rank,
    indexed flat); idx is a flat index array."""
    t = np.asarray(table).reshape(-1)
    tj = jnp.asarray(t)
    ar = jnp.arange(t.shape[0], dtype=jnp.int32)
    return jnp.sum(jnp.where(idx[..., None] == ar, tj, 0), axis=-1)


def _ue_len(v):
    """Bit length of ue(v) for v < 2^16 (vectorized, int32)."""
    vp1 = v.astype(jnp.int32) + 1
    nbits = jnp.zeros_like(vp1)
    for k in range(1, 18):
        nbits = nbits + (vp1 >= (1 << k))
    return 2 * nbits + 1


def ue_dev(v):
    """(code, len) of unsigned Exp-Golomb."""
    code = (v + 1).astype(jnp.uint32)
    return code, _ue_len(v)


def se_dev(v):
    m = jnp.where(v <= 0, -2 * v, 2 * v - 1)
    return ue_dev(m)


def _reverse_nonzeros_dev(coeffs):
    """[B, L] zig-zag coeffs -> (levels_rev, pos_rev, total).

    Rank-based compaction (no sort): a nonzero at position i lands at
    reversed index r = #nonzeros at positions > i; gathered by a one-hot
    contraction over the (tiny) L axis instead of an argsort."""
    B, L = coeffs.shape
    nz = coeffs != 0
    nzi = nz.astype(jnp.int32)
    total = jnp.sum(nzi, axis=1)
    # rank from the end for each nonzero position
    rank = total[:, None] - jnp.cumsum(nzi, axis=1)          # [B, L]
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    k = jnp.arange(L, dtype=jnp.int32)[:, None, None]        # [L,1,1]
    onehot = nz[None, :, :] & (rank[None, :, :] == k)        # [L, B, L]
    levels_rev = jnp.sum(jnp.where(onehot, coeffs[None], 0), axis=2).T
    pos_rev = jnp.sum(jnp.where(onehot, pos[None], 0), axis=2).T
    valid = jnp.arange(L, dtype=jnp.int32)[None, :] < total[:, None]
    return (jnp.where(valid, levels_rev, 0),
            jnp.where(valid, pos_rev, -1), total)


def residual_blocks_dev(coeffs, nc, chroma_dc: bool = False):
    """Device CAVLC for a batch of blocks.

    coeffs [B, L] int32 zig-zag; nc [B]. Returns
    (codes [B,36] uint32, lens [B,36] int32, total [B]).
    Columns are accumulated in Python lists and stacked once (a .at[:,k].set
    per slot would copy the whole [B,36] buffer 30+ times)."""
    B, L = coeffs.shape
    code_cols = [None] * BLOCK_SLOTS
    len_cols = [None] * BLOCK_SLOTS
    zero_u = jnp.zeros((B,), jnp.uint32)
    zero_i = jnp.zeros((B,), jnp.int32)
    levels_rev, pos_rev, total = _reverse_nonzeros_dev(coeffs)

    is_one = jnp.abs(levels_rev[:, :3]) == 1
    lead = jnp.cumprod(is_one, axis=1)
    t1 = jnp.minimum(jnp.sum(lead, axis=1).astype(jnp.int32), total)

    if chroma_dc:
        cls = jnp.full((B,), 4 if L == 4 else 5, jnp.int32)
    else:
        ncv = jnp.asarray(nc, jnp.int32)
        cls = jnp.where(ncv < 2, 0,
                        jnp.where(ncv < 4, 1, jnp.where(ncv < 8, 2, 3)))
    ct_shape = V.COEFF_TOKEN_CODE.shape
    ti = jnp.maximum(total - 1, 0)
    ct_idx = (cls * ct_shape[1] + ti) * ct_shape[2] + t1
    c0 = lut(V.COEFF0_TOKEN_CODE.astype(np.uint32), cls)
    c0l = lut(V.COEFF0_TOKEN_LEN, cls)
    code_cols[0] = jnp.where(total == 0, c0,
                             lut(V.COEFF_TOKEN_CODE.astype(np.uint32),
                                 ct_idx))
    len_cols[0] = jnp.where(total == 0, c0l, lut(V.COEFF_TOKEN_LEN, ct_idx))

    for k in range(3):
        active = k < t1
        code_cols[1 + k] = jnp.where(
            active, (levels_rev[:, k] < 0).astype(jnp.uint32), zero_u)
        len_cols[1 + k] = jnp.where(active, 1, zero_i)

    sl = jnp.where((total > 10) & (t1 < 3), 1, 0).astype(jnp.int32)
    over = jnp.zeros((B,), bool)
    maxk = min(L, 16)
    for k in range(maxk):
        lv = levels_rev[:, k]
        active = (k >= t1) & (k < total)
        lc = jnp.where(lv > 0, 2 * lv - 2, -2 * lv - 1)
        lc = jnp.where((k == t1) & (t1 < 3), lc - 2, lc)
        lc = jnp.maximum(lc, 0)
        # suffixLength == 0 branch
        c0v = jnp.where(
            lc < 14, jnp.uint32(1),
            jnp.where(lc < 30,
                      jnp.uint32(1 << 4) | (lc - 14).astype(jnp.uint32),
                      jnp.uint32(1 << 12)
                      | jnp.minimum(lc - 30, 4095).astype(jnp.uint32)))
        l0v = jnp.where(lc < 14, lc + 1, jnp.where(lc < 30, 19, 28))
        over0 = lc > 30 + 4095
        # suffixLength > 0 branch
        slp = jnp.maximum(sl, 1)
        prefix = lc >> slp
        mask = (1 << slp) - 1
        cpv = ((jnp.uint32(1) << slp.astype(jnp.uint32))
               | (lc & mask).astype(jnp.uint32))
        lpv = prefix + 1 + slp
        esc = prefix >= 15
        cpv = jnp.where(
            esc, jnp.uint32(1 << 12)
            | jnp.clip(lc - (15 << slp), 0, 4095).astype(jnp.uint32), cpv)
        lpv = jnp.where(esc, 28, lpv)
        overp = esc & (lc - (15 << slp) > 4095)
        use0 = sl == 0
        # level escape overflow: the value is not CAVLC-representable at
        # this suffix length; the frame must re-encode at higher QP
        # (reference h->mb.b_overflow, encoder.c:2893)
        over = over | (active & jnp.where(use0, over0, overp))
        code_cols[4 + k] = jnp.where(active, jnp.where(use0, c0v, cpv),
                                     zero_u)
        len_cols[4 + k] = jnp.where(active, jnp.where(use0, l0v, lpv),
                                    zero_i)
        new_sl = jnp.maximum(sl, 1)
        new_sl = new_sl + ((jnp.abs(lv) > (3 << (new_sl - 1)))
                           & (new_sl < 6))
        sl = jnp.where(active, new_sl, sl)

    tz = jnp.where(total > 0, pos_rev[:, 0] + 1 - total, 0)
    write_tz = (total > 0) & (total < L)
    if chroma_dc and L == 4:
        tzc, tzl = V.TOTAL_ZEROS_2x2_CODE, V.TOTAL_ZEROS_2x2_LEN
        trow = jnp.minimum(ti, 2)
        tcol = jnp.clip(tz, 0, 3)
    elif chroma_dc:
        tzc, tzl = V.TOTAL_ZEROS_2x4_CODE, V.TOTAL_ZEROS_2x4_LEN
        trow = jnp.minimum(ti, 6)
        tcol = jnp.clip(tz, 0, 7)
    else:
        tzc, tzl = V.TOTAL_ZEROS_CODE, V.TOTAL_ZEROS_LEN
        trow = jnp.minimum(ti, 14)
        tcol = jnp.clip(tz, 0, 15)
    tz_idx = trow * tzc.shape[1] + tcol
    code_cols[20] = jnp.where(write_tz, lut(tzc.astype(np.uint32), tz_idx),
                              zero_u)
    len_cols[20] = jnp.where(write_tz, lut(tzl, tz_idx), zero_i)

    rb_w = V.RUN_BEFORE_CODE.shape[1]
    zleft = jnp.where(write_tz, tz, 0)
    for k in range(maxk - 1):
        run = pos_rev[:, k] - pos_rev[:, k + 1] - 1
        active = (k < total - 1) & (zleft > 0)
        run = jnp.where(active, run, 0)
        ridx = jnp.clip(zleft - 1, 0, 6)
        rcol = jnp.clip(run, 0, 15)
        rb_idx = ridx * rb_w + rcol
        code_cols[21 + k] = jnp.where(
            active, lut(V.RUN_BEFORE_CODE.astype(np.uint32), rb_idx), zero_u)
        len_cols[21 + k] = jnp.where(active, lut(V.RUN_BEFORE_LEN, rb_idx),
                                     zero_i)
        zleft = jnp.where(active, zleft - run, zleft)

    for k in range(BLOCK_SLOTS):
        if code_cols[k] is None:
            code_cols[k] = zero_u
            len_cols[k] = zero_i
    codes = jnp.stack(code_cols, axis=1)
    lens = jnp.stack(len_cols, axis=1)
    return codes, lens, total, over


def pack_mb_stream(codes, lens, mb_cap_words: int, cap_words: int,
                   slot_chunk: int = 64, force_over=False):
    """Pack grouped (code,len≤32) elements MSB-first into uint32 big-endian
    words. codes/lens are [M, S]: M groups (MBs), S slots each, stream order
    = row-major.

    Two-phase design (avoids both a flat 7.7M-element scatter and a
    gather-based tree):
      A. slots -> per-MB buffers [M, mb_cap_words+1] by dense one-hot word
         placement, reduced over slots in static chunks (pure VPU math,
         fusion-friendly, no gather/scatter).
      B. MB buffers -> frame stream: bit-align each buffer (elementwise
         funnel shift) and scatter-add rows at their word offsets — only
         M*(mb_cap_words+2) updates instead of M*S*2.

    A group whose bits exceed mb_cap_words*32 cannot be represented; the
    returned total_bits is then forced past cap_words*32 so the host takes
    the same overflow/re-encode path as a frame-level overflow.
    Returns (words [cap_words] uint32, total_bits int32)."""
    M, S = codes.shape
    codes = codes.astype(jnp.uint32)
    lens = jnp.clip(lens.astype(jnp.int32), 0, 32)
    codes = jnp.where(lens > 0, codes, 0)
    Wm = mb_cap_words + 1

    ends = jnp.cumsum(lens, axis=1)
    mb_bits = ends[:, -1]                               # [M]
    starts = ends - lens
    w0 = starts >> 5
    bit_in = starts & 31
    end = bit_in + lens                                 # 0..63
    # contribution to word w0 (high part) and w0+1 (low spill)
    t0 = codes >> jnp.maximum(end - 32, 0).astype(jnp.uint32)
    v0 = t0 << (32 - jnp.minimum(end, 32)).astype(jnp.uint32)
    low_n = jnp.maximum(end - 32, 0)
    low = codes & ((jnp.uint32(1) << low_n.astype(jnp.uint32)) - 1)
    v1 = jnp.where(low_n > 0, low << (64 - end).astype(jnp.uint32),
                   jnp.uint32(0))

    # phase A: dense one-hot placement, chunked over slots
    wi = jnp.arange(Wm, dtype=jnp.int32)[None, None, :]
    acc = jnp.zeros((M, Wm), jnp.uint32)
    for s0 in range(0, S, slot_chunk):
        s1 = min(s0 + slot_chunk, S)
        w0c = w0[:, s0:s1, None]
        # disjoint bit ranges within a word -> sum == or
        a0 = jnp.sum(jnp.where(wi == w0c, v0[:, s0:s1, None], 0), axis=1)
        a1 = jnp.sum(jnp.where(wi == w0c + 1, v1[:, s0:s1, None], 0), axis=1)
        acc = acc + a0 + a1
    mb_over = jnp.any(mb_bits > mb_cap_words * 32) | force_over

    # phase B: bit-align MB buffers and scatter at word offsets
    mb_end = jnp.cumsum(mb_bits)
    total_bits = mb_end[-1]
    mb_start = mb_end - mb_bits
    r = (mb_start & 31).astype(jnp.uint32)[:, None]
    prev = jnp.concatenate([jnp.zeros((M, 1), jnp.uint32), acc[:, :-1]],
                           axis=1)
    shifted = jnp.where(r > 0, (acc >> r) | (prev << ((32 - r) & 31)),
                        acc)
    # one spill word past the buffer
    spill = jnp.where(r > 0, acc[:, -1:] << ((32 - r) & 31),
                      jnp.zeros((M, 1), jnp.uint32))
    shifted = jnp.concatenate([shifted, spill], axis=1)   # [M, Wm+1]
    word_idx = (mb_start >> 5)[:, None] + jnp.arange(Wm + 1,
                                                     dtype=jnp.int32)[None]
    words = jnp.zeros((cap_words,), jnp.uint32)
    words = words.at[word_idx.reshape(-1)].add(shifted.reshape(-1),
                                               mode="drop")
    total_bits = jnp.where(mb_over, cap_words * 32, total_bits)
    return words, total_bits


def pack_bits_dev(codes, lens, cap_words: int):
    """Flat-stream compatibility wrapper over pack_mb_stream (one group)."""
    return pack_mb_stream(codes.reshape(1, -1), lens.reshape(1, -1),
                          cap_words - 1, cap_words)


def _nc_grid_dev(nnz_tiles, mbh: int, mbw: int, bs: int):
    """nnz_tiles [N, bs*bs] raster-in-MB -> nC [N, bs*bs]."""
    n = mbh * mbw
    grid = nnz_tiles.reshape(mbh, mbw, bs, bs).transpose(0, 2, 1, 3) \
        .reshape(mbh * bs, mbw * bs)
    na = jnp.pad(grid, ((0, 0), (1, 0)))[:, :-1]
    nb = jnp.pad(grid, ((1, 0), (0, 0)))[:-1, :]
    col = jnp.arange(mbw * bs)[None, :]
    row = jnp.arange(mbh * bs)[:, None]
    has_a = col > 0
    has_b = row > 0
    nc = jnp.where(has_a & has_b, (na + nb + 1) >> 1,
                   jnp.where(has_a, na, jnp.where(has_b, nb, 0)))
    return nc.reshape(mbh, bs, mbw, bs).transpose(0, 2, 1, 3).reshape(
        n, bs * bs)


@partial(jax.jit, static_argnames=("mbw", "mbh", "cap_words"))
def encode_i16x16_frame_dev(i16_mode, chroma_mode, qp_flat, slice_qp,
                            dc_blk, ac_blk, cdc_blk, cac_blk,
                            *, mbw: int, mbh: int, cap_words: int,
                            is_i4=None, i4_modes=None):
    """Full I-slice MB-layer entropy on device (I16x16 + I_4x4).

    dc_blk [N,4,4] (hadamard-domain levels, raster), ac_blk [N,16,4,4]
    (raster blocks; I16 rows pos0-zeroed AC, I4 rows full 16-coeff
    levels), cdc_blk [N,2,2,2], cac_blk [N,2,4,4,4]. is_i4 [N] bool +
    i4_modes [N,16] raster-block spec modes enable I_4x4 MBs (mb_type
    ue(0), per-block MPM mode coding per spec 8.3.1.1, cbp ue with the
    intra golomb map, dqp only when cbp != 0).
    Returns (words, total_bits, eff_qp) — eff_qp is the decoder-carried
    per-MB QP (I4 MBs without residual inherit), for deblock."""
    n = mbw * mbh
    if is_i4 is None:
        is_i4 = jnp.zeros((n,), bool)
        i4_modes = jnp.zeros((n, 16), jnp.int32)
    zig = jnp.asarray(ZIGZAG4_FRAME)
    dc_z = dc_blk.reshape(n, 16)[:, zig]
    ac_z = ac_blk.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)                      # raster 2x2 scan
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]

    # mixed nnz grid: I16 rows count the 15 AC coeffs, I4 rows all 16
    nnz_ac = jnp.sum(ac_z[:, :, 1:] != 0, axis=2).astype(jnp.int32)
    nnz_full = jnp.sum(ac_z != 0, axis=2).astype(jnp.int32)
    nnz_mixed = jnp.where(is_i4[:, None], nnz_full, nnz_ac)
    nc_l = _nc_grid_dev(nnz_mixed, mbh, mbw, 4)
    dc_codes, dc_lens, _, dc_ov = residual_blocks_dev(dc_z, nc_l[:, 0])
    ac_codes, ac_lens, _, ac_ov = residual_blocks_dev(
        ac_z[:, :, 1:].reshape(n * 16, 15), nc_l.reshape(-1))
    ac_codes = ac_codes.reshape(n, 16, BLOCK_SLOTS)
    ac_lens = ac_lens.reshape(n, 16, BLOCK_SLOTS)
    l16_codes, l16_lens, _, l16_ov = residual_blocks_dev(
        ac_z.reshape(n * 16, 16), nc_l.reshape(-1))
    l16_codes = l16_codes.reshape(n, 16, BLOCK_SLOTS)
    l16_lens = l16_lens.reshape(n, 16, BLOCK_SLOTS)
    i43 = is_i4[:, None, None]
    ac_codes = jnp.where(i43, l16_codes, ac_codes)
    ac_lens = jnp.where(i43, l16_lens, ac_lens)
    ac_ov = jnp.where(is_i4[:, None], l16_ov.reshape(n, 16),
                      ac_ov.reshape(n, 16))
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), jnp.zeros(n * 2, jnp.int32), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    nnz_cac = jnp.sum(cac_z[:, :, :, 1:] != 0, axis=3).astype(jnp.int32)
    nc_u = _nc_grid_dev(nnz_cac[:, 0], mbh, mbw, 2)
    nc_v = _nc_grid_dev(nnz_cac[:, 1], mbh, mbw, 2)
    nc_c = jnp.stack([nc_u, nc_v], axis=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)
    lvl_over = (jnp.any(dc_ov & ~is_i4[:, None].reshape(n, 1))
                | jnp.any(ac_ov) | jnp.any(cdc_ov) | jnp.any(cac_ov))

    cbp_luma16 = jnp.sum(nnz_ac, axis=1) > 0
    # per-quadrant cbp bits for I4 (full-coeff counts)
    blk_r = jnp.arange(16)
    quad = (blk_r // 4 // 2) * 2 + (blk_r % 4) // 2     # raster -> 8x8 id
    cbp4 = jnp.zeros((n,), jnp.int32)
    for qd in range(4):
        qnnz = jnp.sum(jnp.where(jnp.asarray(quad == qd)[None, :],
                                 nnz_full, 0), axis=1)
        cbp4 = cbp4 | jnp.where(qnnz > 0, 1 << qd, 0)
    any_cac = jnp.sum(nnz_cac.reshape(n, 8), axis=1) > 0
    any_cdc = jnp.sum(cdc != 0, axis=(1, 2)) > 0
    cbp_chroma = jnp.where(any_cac, 2, jnp.where(any_cdc, 1, 0))
    mb_type = jnp.where(
        is_i4, 0, 1 + i16_mode + 4 * cbp_chroma + 12 * cbp_luma16)

    m_codes, m_lens = _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw)

    # ---- header slots: mb_type, 16 modes, chroma_mode, cbp, dqp ----
    h_codes = jnp.zeros((n, 20), jnp.uint32)
    h_lens = jnp.zeros((n, 20), jnp.int32)
    c, l = ue_dev(mb_type)                       # noqa: E741
    h_codes = h_codes.at[:, 0].set(c)
    h_lens = h_lens.at[:, 0].set(l)
    h_codes = h_codes.at[:, 1:17].set(m_codes)
    h_lens = h_lens.at[:, 1:17].set(m_lens)
    c, l = ue_dev(chroma_mode)                   # noqa: E741
    h_codes = h_codes.at[:, 17].set(c)
    h_lens = h_lens.at[:, 17].set(l)
    c, l = ue_dev(lut(V.CBP_TO_GOLOMB_INTRA,     # noqa: E741
                      cbp_chroma * 16 + cbp4))
    h_codes = h_codes.at[:, 18].set(c)
    h_lens = h_lens.at[:, 18].set(jnp.where(is_i4, l, 0))
    # dqp: always for I16; only with residual for I4 (decoder-carried
    # qp chain skips dqp-less MBs)
    has_dqp = (~is_i4) | (cbp4 > 0) | (cbp_chroma > 0)
    idxs = jnp.arange(n, dtype=jnp.int32)
    last_d = jax.lax.cummax(jnp.where(has_dqp, idxs, -1))
    prev_d = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_d[:-1]])
    prev_qp = jnp.where(prev_d >= 0, qp_flat[jnp.maximum(prev_d, 0)],
                        slice_qp)
    eff_qp = jnp.where(has_dqp, qp_flat, prev_qp)
    c, l = se_dev(jnp.where(has_dqp, qp_flat - prev_qp, 0))  # noqa: E741
    h_codes = h_codes.at[:, 19].set(c)
    h_lens = h_lens.at[:, 19].set(jnp.where(has_dqp, l, 0))

    # ---- gating ----
    dc_lens = jnp.where(is_i4[:, None], 0, dc_lens)
    qbit = (cbp4[:, None] >> jnp.asarray(quad)[None, :]) & 1
    luma_on = jnp.where(is_i4[:, None], qbit > 0,
                        cbp_luma16[:, None])
    ac_lens = jnp.where(luma_on[:, :, None], ac_lens, 0)
    cdc_lens = jnp.where((cbp_chroma > 0)[:, None, None], cdc_lens, 0)
    cac_lens = jnp.where((cbp_chroma == 2)[:, None, None], cac_lens, 0)

    order = jnp.asarray(LUMA4x4_RASTER)
    ac_codes = ac_codes[:, order]
    ac_lens = ac_lens[:, order]

    codes = jnp.concatenate([
        h_codes, dc_codes,
        ac_codes.reshape(n, -1),
        cdc_codes.reshape(n, -1),
        cac_codes.reshape(n, -1)], axis=1)
    lens = jnp.concatenate([
        h_lens, dc_lens,
        ac_lens.reshape(n, -1),
        cdc_lens.reshape(n, -1),
        cac_lens.reshape(n, -1)], axis=1)
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


def _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw):
    """(codes, lens) [N,16] in z-scan emission order for the 16
    prev_intra4x4_pred_mode_flag / rem elements (spec 8.3.1.1 MPM)."""
    n = mbh * mbw
    i4_mb_grid = is_i4.reshape(mbh, mbw)
    mode_grid = i4_modes.reshape(mbh, mbw, 4, 4) \
        .transpose(0, 2, 1, 3).reshape(mbh * 4, mbw * 4)
    mode_grid = jnp.where(
        jnp.repeat(jnp.repeat(i4_mb_grid, 4, 0), 4, 1), mode_grid, 2)
    mA = jnp.pad(mode_grid, ((0, 0), (1, 0)), constant_values=2)[:, :-1]
    mB = jnp.pad(mode_grid, ((1, 0), (0, 0)), constant_values=2)[:-1, :]
    av_a = jnp.arange(mbw * 4)[None, :] > 0
    av_b = jnp.arange(mbh * 4)[:, None] > 0
    mpm_grid = jnp.where(av_a & av_b, jnp.minimum(mA, mB), 2)
    mpm = mpm_grid.reshape(mbh, 4, mbw, 4).transpose(0, 2, 1, 3) \
        .reshape(n, 16)
    m = i4_modes
    flag = m == mpm
    rem = m - (m > mpm).astype(m.dtype)
    m_codes = jnp.where(flag, 1, rem).astype(jnp.uint32)
    m_lens = jnp.where(is_i4[:, None], jnp.where(flag, 1, 4), 0) \
        .astype(jnp.int32)
    zorder = jnp.asarray(LUMA4x4_RASTER)
    return m_codes[:, zorder], m_lens[:, zorder]


def _pframe_mb_codes(skip, mvd, cbp_luma, cbp_chroma, qp_flat,
                     slice_qp, luma_lv, cdc_blk, cac_blk,
                     *, mbw: int, mbh: int,
                     is_intra=None, i16_mode=None,
                     chroma_mode=None, luma_dc=None,
                     part_mode=None, mvd2=None, mvd23=None,
                     is_i4=None, i4_modes=None,
                     refidx=None, two_refs: bool = False,
                     two_refs_live=None):
    """P-slice MB layer element table: (codes [N,S], lens [N,S],
    eff_qp [N], lvl_over scalar, trailing scalar). Shared by the packing
    writer (encode_pframe_entropy_dev) and the RD tier (encoder/rdo.py),
    which needs exact per-MB bit counts = lens.sum(1)."""
    n = mbw * mbh
    if part_mode is None:
        part_mode = jnp.zeros((n,), jnp.int32)
        mvd2 = jnp.zeros((n, 2), jnp.int32)
    if mvd23 is None:
        mvd23 = jnp.zeros((n, 2, 2), jnp.int32)
    if is_i4 is None:
        is_i4 = jnp.zeros((n,), bool)
        i4_modes = jnp.zeros((n, 16), jnp.int32)
    zig = jnp.asarray(ZIGZAG4_FRAME)
    luma_z = luma_lv.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]
    if is_intra is None:
        is_intra = jnp.zeros((n,), bool)
        i16_mode = jnp.zeros((n,), jnp.int32)
        chroma_mode = jnp.zeros((n,), jnp.int32)
        luma_dc = jnp.zeros((n, 4, 4), jnp.int32)

    # ---- skip runs ----
    idx = jnp.arange(n, dtype=jnp.int32)
    coded = ~skip
    last_coded = jax.lax.cummax(jnp.where(coded, idx, -1))
    prev_coded = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), last_coded[:-1]])
    run = jnp.where(coded, idx - prev_coded - 1, 0)
    trailing = n - 1 - last_coded[-1]      # skips after the last coded MB

    # ---- residual blocks ----
    # mixed-frame luma nnz grid: inter rows count 16 coeffs, intra rows
    # count the 15 AC (pos 0 is zeroed) — the spec TotalCoeff semantics
    nnz_l = jnp.sum(luma_z != 0, axis=2).astype(jnp.int32)
    nc_l = _nc_grid_dev(nnz_l, mbh, mbw, 4)
    l_codes, l_lens, _, l_ov = residual_blocks_dev(
        luma_z.reshape(n * 16, 16), nc_l.reshape(-1))
    l_codes = l_codes.reshape(n, 16, BLOCK_SLOTS)
    l_lens = l_lens.reshape(n, 16, BLOCK_SLOTS)
    # intra variants: 15-coeff AC blocks + the 16-coeff DC block
    dc_z = luma_dc.reshape(n, 16)[:, zig]
    dc_codes, dc_lens, _, dc_ov = residual_blocks_dev(dc_z, nc_l[:, 0])
    l15_codes, l15_lens, _, l15_ov = residual_blocks_dev(
        luma_z[:, :, 1:].reshape(n * 16, 15), nc_l.reshape(-1))
    l15_codes = l15_codes.reshape(n, 16, BLOCK_SLOTS)
    l15_lens = l15_lens.reshape(n, 16, BLOCK_SLOTS)
    is_i16 = is_intra & ~is_i4
    ii3 = is_i16[:, None, None]
    l_codes = jnp.where(ii3, l15_codes, l_codes)
    l_lens = jnp.where(ii3, l15_lens, l_lens)
    l_ov = jnp.where(is_i16[:, None],
                     l15_ov.reshape(n, 16), l_ov.reshape(n, 16))
    dc_lens = jnp.where(is_i16[:, None], dc_lens, 0)
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), jnp.zeros(n * 2, jnp.int32), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    nnz_cac = jnp.sum(cac_z[:, :, :, 1:] != 0, axis=3).astype(jnp.int32)
    nc_u = _nc_grid_dev(nnz_cac[:, 0], mbh, mbw, 2)
    nc_v = _nc_grid_dev(nnz_cac[:, 1], mbh, mbw, 2)
    nc_c = jnp.stack([nc_u, nc_v], axis=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)

    # ---- header elements: run, mb_type, m0..m15 (I4 mode elements,
    # z-scan), sub_mb_types (P_8x8: 4x ue(0) = '1111'), ref_p0..ref_p3
    # (te ref_idx, 2-ref inter only), mvd0_x|chroma_mode,
    # mvd0_y|dqp(I16), mvd1_x, mvd1_y (partitioned inter only),
    # mvd2/mvd3 pairs (P_8x8 only), cbp(inter/I4), qp_delta(inter/I4) --
    h_codes = jnp.zeros((n, 33), jnp.uint32)
    h_lens = jnp.zeros((n, 33), jnp.int32)
    c, l = ue_dev(run)                          # noqa: E741
    h_codes = h_codes.at[:, 0].set(c)
    h_lens = h_lens.at[:, 0].set(l)
    # carried-QP chain: inter/I4 MBs with residual + every I16 MB (dqp
    # always coded for I16) update the decoder's QP
    has_resid = (((cbp_luma > 0) | (cbp_chroma > 0)) & coded) \
        | (is_i16 & coded)
    idxs = jnp.arange(n, dtype=jnp.int32)
    last_r = jax.lax.cummax(jnp.where(has_resid, idxs, -1))
    prev_r = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_r[:-1]])
    prev_qp = jnp.where(prev_r >= 0, qp_flat[jnp.maximum(prev_r, 0)],
                        slice_qp)
    dqp = qp_flat - prev_qp
    eff_qp = jnp.where(has_resid, qp_flat, prev_qp)
    # mb_type: inter ue(part_mode) (0=16x16/1=16x8/2=8x16); I4 ue(5);
    # I16 ue(6 + I16 code) (spec table 7-13)
    i16_code = 6 + i16_mode + 4 * cbp_chroma \
        + 12 * (cbp_luma > 0).astype(jnp.int32)
    i_code = jnp.where(is_i4, 5, i16_code)
    c_i, l_i = ue_dev(i_code)
    c, l = ue_dev(part_mode)                    # noqa: E741
    h_codes = h_codes.at[:, 1].set(jnp.where(is_intra, c_i, c))
    h_lens = h_lens.at[:, 1].set(jnp.where(is_intra, l_i, l))
    m_codes, m_lens = _i4_mode_codes_dev(is_i4, i4_modes, mbh, mbw)
    h_codes = h_codes.at[:, 2:18].set(m_codes)
    h_lens = h_lens.at[:, 2:18].set(
        jnp.where(coded[:, None], m_lens, 0))
    part2 = (part_mode > 0) & ~is_intra
    p88 = (part_mode == 3) & ~is_intra
    # sub_mb_type: P_8x8 codes four ue(0)='1' bits (all P_L0_8x8)
    h_codes = h_codes.at[:, 18].set(0b1111)
    h_lens = h_lens.at[:, 18].set(jnp.where(p88, 4, 0))
    if two_refs:
        # te() ref_idx (cMax=1): one inverted bit per partition, all
        # partitions' ref_idx precede the mvd pairs (spec 7.3.5.1/.2)
        live = (jnp.asarray(True) if two_refs_live is None
                else two_refs_live)
        ref_bit = (1 - refidx).astype(jnp.uint32)
        gates = (~is_intra & live, part2 & live, p88 & live, p88 & live)
        for pi, gate in enumerate(gates):
            h_codes = h_codes.at[:, 19 + pi].set(ref_bit)
            h_lens = h_lens.at[:, 19 + pi].set(jnp.where(gate, 1, 0))
    c_cm, l_cm = ue_dev(chroma_mode)
    c, l = se_dev(mvd[:, 0])                    # noqa: E741
    h_codes = h_codes.at[:, 23].set(jnp.where(is_intra, c_cm, c))
    h_lens = h_lens.at[:, 23].set(jnp.where(is_intra, l_cm, l))
    c_dq, l_dq = se_dev(jnp.where(has_resid, dqp, 0))
    c, l = se_dev(mvd[:, 1])                    # noqa: E741
    h_codes = h_codes.at[:, 24].set(jnp.where(is_intra, c_dq, c))
    h_lens = h_lens.at[:, 24].set(
        jnp.where(is_i4, 0, jnp.where(is_intra, l_dq, l)))
    # second-partition mvd (16x8/8x16/P_8x8)
    for comp, slot in ((0, 25), (1, 26)):
        c, l = se_dev(mvd2[:, comp])            # noqa: E741
        h_codes = h_codes.at[:, slot].set(c)
        h_lens = h_lens.at[:, slot].set(jnp.where(part2, l, 0))
    # quadrant 2/3 mvds (P_8x8 only)
    for pi, base in ((0, 27), (1, 29)):
        for comp in range(2):
            c, l = se_dev(mvd23[:, pi, comp])   # noqa: E741
            h_codes = h_codes.at[:, base + comp].set(c)
            h_lens = h_lens.at[:, base + comp].set(jnp.where(p88, l, 0))
    # cbp: inter golomb map for inter MBs, intra map for I4, none for I16
    c, l = ue_dev(lut(V.CBP_TO_GOLOMB_INTER,              # noqa: E741
                      cbp_chroma * 16 + cbp_luma))
    c4, l4 = ue_dev(lut(V.CBP_TO_GOLOMB_INTRA,
                        cbp_chroma * 16 + cbp_luma))
    h_codes = h_codes.at[:, 31].set(jnp.where(is_i4, c4, c))
    h_lens = h_lens.at[:, 31].set(
        jnp.where(is_i4, l4, jnp.where(is_intra, 0, l)))
    h_codes = h_codes.at[:, 32].set(c_dq)
    h_lens = h_lens.at[:, 32].set(
        jnp.where(is_i16, 0, jnp.where(has_resid, l_dq, 0)))

    # ---- gating ----
    coded3 = coded[:, None, None]
    h_lens = jnp.where(coded[:, None], h_lens, 0)
    # luma blocks: inter -> quadrant bit; intra -> cbp_luma 15 (all)
    blk_r = jnp.arange(16)
    quad = (blk_r // 4 // 2) * 2 + (blk_r % 4) // 2        # raster -> 8x8 id
    qbit = (cbp_luma[:, None] >> quad[None, :]) & 1
    l_lens = jnp.where((qbit > 0)[:, :, None] & coded3, l_lens, 0)
    dc_lens = jnp.where(coded[:, None], dc_lens, 0)
    cdc_lens = jnp.where((cbp_chroma > 0)[:, None, None] & coded3,
                         cdc_lens, 0)
    cac_lens = jnp.where((cbp_chroma == 2)[:, None, None] & coded3,
                         cac_lens, 0)
    order = jnp.asarray(LUMA4x4_RASTER)
    l_codes = l_codes[:, order]
    l_lens = l_lens[:, order]

    codes = jnp.concatenate([
        h_codes, dc_codes, l_codes.reshape(n, -1),
        cdc_codes.reshape(n, -1), cac_codes.reshape(n, -1)], axis=1)
    lens = jnp.concatenate([
        h_lens, dc_lens, l_lens.reshape(n, -1),
        cdc_lens.reshape(n, -1), cac_lens.reshape(n, -1)], axis=1)
    # level overflow only matters for blocks that are actually written
    lvl_over = (jnp.any(l_ov.reshape(n, 16) & (l_lens.sum(2) > 0))
                | jnp.any(dc_ov.reshape(n) & (dc_lens.sum(1) > 0))
                | jnp.any(cdc_ov.reshape(n, 2) & (cdc_lens.sum(2) > 0))
                | jnp.any(cac_ov.reshape(n, 8) & (cac_lens.sum(2) > 0)))
    return codes, lens, eff_qp, lvl_over, trailing


def pframe_mb_bits(*args, **kwargs):
    """Exact per-MB CAVLC bit counts [N] for one full-frame candidate
    assignment — the RD tier's bit model (rdo.c:162 re-expressed: instead
    of re-encoding one MB in isolation, the whole frame's element table
    is built batched and summed per MB row)."""
    _, lens, _, _, _ = _pframe_mb_codes(*args, **kwargs)
    return jnp.sum(lens, axis=1)


@partial(jax.jit, static_argnames=("mbw", "mbh", "cap_words", "two_refs"))
def encode_pframe_entropy_dev(skip, mvd, cbp_luma, cbp_chroma, qp_flat,
                              slice_qp, luma_lv, cdc_blk, cac_blk,
                              *, mbw: int, mbh: int, cap_words: int,
                              is_intra=None, i16_mode=None,
                              chroma_mode=None, luma_dc=None,
                              part_mode=None, mvd2=None, mvd23=None,
                              is_i4=None, i4_modes=None,
                              refidx=None, two_refs: bool = False,
                              two_refs_live=None):
    """P-slice MB layer on device (P_L0_16x16/16x8/8x16/P_8x8 + P_Skip +
    I16-in-P, 1 or 2 refs).

    With two_refs, refidx [N] in {0,1} is coded te() (spec 9.1.1,
    cMax=1: bit = !value) once per partition before the mvd pairs
    (cavlc.c:510 both-partition loop); both partitions of an MB share
    one reference here. two_refs_live (traced bool scalar) gates the
    ref_idx bits at runtime so the first-P-after-IDR (l0_active = 1)
    shares the compiled program with steady-state 2-ref frames.

    skip [N] bool; mvd [N,2]; cbp_* [N]; luma_lv [N,16,4,4] (full 16-coeff
    inter blocks / pos0-zeroed intra AC blocks, raster); cdc_blk
    [N,2,2,2]; cac_blk [N,2,4,4,4]. Intra-in-P (spec mb_type 5..30 in P,
    analyse.c:2939): is_intra [N] bool + i16_mode/chroma_mode [N] +
    luma_dc [N,4,4] hadamard-domain DC levels. Partitions (spec table
    7-13, cavlc.c:487 P branches): part_mode [N] 0=16x16 1=16x8 2=8x16
    3=P_8x8 (= the mb_type ue code) with mvd2 [N,2] the second
    partition's mvd and mvd23 [N,2,2] quadrants 2-3 (P_8x8 only; its
    sub_mb_pred codes four sub_mb_type ue(0)=P_L0_8x8 bits, then all
    ref_idx, then the four mvd pairs — spec 7.3.5.2).
    Returns (words, total_bits, eff_qp) — eff_qp is the decoder-carried
    per-MB QP (uncoded MBs inherit), needed by the deblock strength qp."""
    n = mbw * mbh
    codes, lens, eff_qp, lvl_over, trailing = _pframe_mb_codes(
        skip, mvd, cbp_luma, cbp_chroma, qp_flat, slice_qp, luma_lv,
        cdc_blk, cac_blk, mbw=mbw, mbh=mbh, is_intra=is_intra,
        i16_mode=i16_mode, chroma_mode=chroma_mode, luma_dc=luma_dc,
        part_mode=part_mode, mvd2=mvd2, mvd23=mvd23, is_i4=is_i4,
        i4_modes=i4_modes, refidx=refidx, two_refs=two_refs,
        two_refs_live=two_refs_live)
    # trailing skip run element: one extra group row in the stream
    tc, tl = ue_dev(jnp.maximum(trailing, 0))
    tl = jnp.where(trailing > 0, tl, 0)
    S = codes.shape[1]
    trow_c = jnp.zeros((1, S), jnp.uint32).at[0, 0].set(tc)
    trow_l = jnp.zeros((1, S), jnp.int32).at[0, 0].set(tl)
    codes = jnp.concatenate([codes, trow_c], axis=0)
    lens = jnp.concatenate([lens, trow_l], axis=0)
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


@partial(jax.jit, static_argnames=("mbw", "mbh", "cap_words"))
def encode_bframe_entropy_dev(mode, mvd0, mvd1, cbp_luma, cbp_chroma,
                              qp_flat, slice_qp, luma_lv, cdc_blk, cac_blk,
                              *, mbw: int, mbh: int, cap_words: int,
                              skip=None):
    """B-slice MB layer on device (B_Skip + B_L0/L1/BI/Direct_16x16,
    1 ref per list; reference cavlc.c:487 B branches).

    mode [N] 0=L0 1=L1 2=BI 3=Direct; mvd0/mvd1 [N,2]; skip [N] bool
    (B_Skip: direct + no residual, coded via mb_skip_run); the rest as
    in the P writer. Returns (words, total_bits, eff_qp)."""
    n = mbw * mbh
    if skip is None:
        skip = jnp.zeros((n,), bool)
    zig = jnp.asarray(ZIGZAG4_FRAME)
    luma_z = luma_lv.reshape(n, 16, 16)[:, :, zig]
    cdc = cdc_blk.reshape(n, 2, 4)
    cac_z = cac_blk.reshape(n, 2, 4, 16)[:, :, :, zig]

    # ---- residual blocks (same machinery as P) ----
    nnz_l = jnp.sum(luma_z != 0, axis=2).astype(jnp.int32)
    nc_l = _nc_grid_dev(nnz_l, mbh, mbw, 4)
    l_codes, l_lens, _, l_ov = residual_blocks_dev(
        luma_z.reshape(n * 16, 16), nc_l.reshape(-1))
    l_codes = l_codes.reshape(n, 16, BLOCK_SLOTS)
    l_lens = l_lens.reshape(n, 16, BLOCK_SLOTS)
    cdc_codes, cdc_lens, _, cdc_ov = residual_blocks_dev(
        cdc.reshape(n * 2, 4), jnp.zeros(n * 2, jnp.int32), chroma_dc=True)
    cdc_codes = cdc_codes.reshape(n, 2, BLOCK_SLOTS)
    cdc_lens = cdc_lens.reshape(n, 2, BLOCK_SLOTS)
    cac_z_nz = jnp.sum(cac_z[:, :, :, 1:] != 0, axis=3).astype(jnp.int32)
    nc_u = _nc_grid_dev(cac_z_nz[:, 0], mbh, mbw, 2)
    nc_v = _nc_grid_dev(cac_z_nz[:, 1], mbh, mbw, 2)
    nc_c = jnp.stack([nc_u, nc_v], axis=1)
    cac_codes, cac_lens, _, cac_ov = residual_blocks_dev(
        cac_z[:, :, :, 1:].reshape(n * 8, 15), nc_c.reshape(-1))
    cac_codes = cac_codes.reshape(n, 8, BLOCK_SLOTS)
    cac_lens = cac_lens.reshape(n, 8, BLOCK_SLOTS)

    # ---- skip runs (B_Skip, reference cavlc.c mb_skip_run) ----
    idx = jnp.arange(n, dtype=jnp.int32)
    coded = ~skip
    last_coded = jax.lax.cummax(jnp.where(coded, idx, -1))
    prev_coded = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32), last_coded[:-1]])
    run = jnp.where(coded, idx - prev_coded - 1, 0)
    trailing = n - 1 - last_coded[-1]

    # ---- header: run, mb_type, mvd l0, mvd l1, cbp, dqp ----
    h_codes = jnp.zeros((n, 8), jnp.uint32)
    h_lens = jnp.zeros((n, 8), jnp.int32)
    c, l = ue_dev(run)                                # noqa: E741
    h_codes = h_codes.at[:, 0].set(c)
    h_lens = h_lens.at[:, 0].set(l)
    # mb_type: B_Direct_16x16 = ue(0), explicit = ue(mode+1)
    c, l = ue_dev(jnp.where(mode == 3, 0, mode + 1))  # noqa: E741
    h_codes = h_codes.at[:, 1].set(c)
    h_lens = h_lens.at[:, 1].set(l)
    use0 = (mode == 0) | (mode == 2)
    use1 = (mode == 1) | (mode == 2)
    for slot, (mvd, use, comp) in enumerate(
            [(mvd0, use0, 0), (mvd0, use0, 1),
             (mvd1, use1, 0), (mvd1, use1, 1)]):
        c, l = se_dev(mvd[:, comp])                   # noqa: E741
        h_codes = h_codes.at[:, 2 + slot].set(c)
        h_lens = h_lens.at[:, 2 + slot].set(jnp.where(use, l, 0))
    c, l = ue_dev(lut(V.CBP_TO_GOLOMB_INTER,          # noqa: E741
                      cbp_chroma * 16 + cbp_luma))
    h_codes = h_codes.at[:, 6].set(c)
    h_lens = h_lens.at[:, 6].set(l)
    has_resid = ((cbp_luma > 0) | (cbp_chroma > 0)) & coded
    idxs = jnp.arange(n, dtype=jnp.int32)
    last_r = jax.lax.cummax(jnp.where(has_resid, idxs, -1))
    prev_r = jnp.concatenate([jnp.full((1,), -1, jnp.int32), last_r[:-1]])
    prev_qp = jnp.where(prev_r >= 0, qp_flat[jnp.maximum(prev_r, 0)],
                        slice_qp)
    c, l = se_dev(jnp.where(has_resid, qp_flat - prev_qp, 0))  # noqa: E741
    h_codes = h_codes.at[:, 7].set(c)
    h_lens = h_lens.at[:, 7].set(jnp.where(has_resid, l, 0))
    eff_qp = jnp.where(has_resid, qp_flat, prev_qp)

    # ---- gating ----
    coded3 = coded[:, None, None]
    h_lens = jnp.where(coded[:, None], h_lens, 0)
    blk_r = jnp.arange(16)
    quad = (blk_r // 4 // 2) * 2 + (blk_r % 4) // 2
    qbit = (cbp_luma[:, None] >> quad[None, :]) & 1
    l_lens = jnp.where((qbit > 0)[:, :, None] & coded3, l_lens, 0)
    cdc_lens = jnp.where((cbp_chroma > 0)[:, None, None] & coded3,
                         cdc_lens, 0)
    cac_lens = jnp.where((cbp_chroma == 2)[:, None, None] & coded3,
                         cac_lens, 0)
    order = jnp.asarray(LUMA4x4_RASTER)
    l_codes = l_codes[:, order]
    l_lens = l_lens[:, order]

    codes = jnp.concatenate([
        h_codes, l_codes.reshape(n, -1),
        cdc_codes.reshape(n, -1), cac_codes.reshape(n, -1)], axis=1)
    lens = jnp.concatenate([
        h_lens, l_lens.reshape(n, -1),
        cdc_lens.reshape(n, -1), cac_lens.reshape(n, -1)], axis=1)
    # trailing skip run element: one extra group row in the stream
    tc, tl = ue_dev(jnp.maximum(trailing, 0))
    tl = jnp.where(trailing > 0, tl, 0)
    S = codes.shape[1]
    trow_c = jnp.zeros((1, S), jnp.uint32).at[0, 0].set(tc)
    trow_l = jnp.zeros((1, S), jnp.int32).at[0, 0].set(tl)
    codes = jnp.concatenate([codes, trow_c], axis=0)
    lens = jnp.concatenate([lens, trow_l], axis=0)
    lvl_over = (jnp.any(l_ov.reshape(n, 16) & (l_lens.sum(2) > 0))
                | jnp.any(cdc_ov.reshape(n, 2) & (cdc_lens.sum(2) > 0))
                | jnp.any(cac_ov.reshape(n, 8) & (cac_lens.sum(2) > 0)))
    words, total_bits = pack_mb_stream(codes, lens, cap_words // n,
                                       cap_words, force_over=lvl_over)
    return words, total_bits, eff_qp


def words_to_bytes(words: np.ndarray, total_bits: int) -> tuple[bytes, int]:
    """Host: big-endian words -> byte string truncated to ceil(total_bits/8).
    Returns (payload, total_bits)."""
    nbytes = (int(total_bits) + 7) // 8
    by = words.astype(">u4").tobytes()[:nbytes]
    return by, int(total_bits)
