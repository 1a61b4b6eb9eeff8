"""Trellis (RD-optimal) quantization — batched Viterbi over CABAC states.

Reference: encoder/rdo.c:642 quant_trellis_cabac. The reference runs an
8-node Viterbi per 4x4 block, sequentially per block inside the MB
encode. The batched form runs the SAME dynamic program as one
`lax.scan` of 16 steps (reverse zigzag order) over ALL blocks of a frame
at once: each step relaxes the 8 node-contexts x 2 candidate levels
(q-1, q) with vectorized per-lane costs. This is the most
batching-friendly piece of rdo.c — every 4x4 block is an independent
lane.

Cost model (same units as the reference):
  score = sum(d^2 * w2[pos]) + lambda2 * bits
where d is the transform-domain reconstruction error, w2 converts
transform-domain SSD to pixel-domain SSD (w2 = 50/(ni*nj) with
ni = squared norms {4,10} of the H.264 forward-transform rows; the
constant 50 matches the reference's fixed-point convention in
x264_dct4_weight2_tab), and lambda2 follows the documented formulas
(tables.c:133): inter 0.85^2 * 2^(qp/3+2), intra 0.65^2 * 2^(qp/3+2)
(in our float units, i.e. the reference's value / 256 / 16 * 256...
folded so that bits are in plain fractional bits).

The 8 node-contexts summarize the spec's coeff_abs_level_minus1 context
increment rules (9.3.3.1.3): node 0 = nothing nonzero yet (in reverse
scan, i.e. the current coef would be "last"), nodes 1-3 = 1/2/3+
trailing ones seen, nodes 4-7 = 1/2/3/4+ levels >1 seen. Contexts
{0, 4, 8, 9} of the abs-level family can repeat along a path and are
tracked adaptively per node (4 packed uint8 states, like the
reference's trellis_node_t.cabac_state); contexts 1,2,3,5,6,7 are
one-shot and read from the slice-init states.

Bit costs derive from the CABAC engine's design probability model
(Marpe et al., IEEE CSVT 2003): p_LPS(s) = 0.5 * alpha^s with
alpha = (0.01875/0.5)^(1/63); cost of a bin = -log2(p(bin)).
State packing: s = (pStateIdx << 1) | valMPS, so s ^ bin has its low
bit = "is LPS" and high bits = pStateIdx.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import tables
from ..entropy import cabac_tables as CT

# --------------------------------------------------------------- tables
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63.0)
_P_LPS = 0.5 * _ALPHA ** np.arange(64)

# ENT[(pstate<<1) | is_lps] = bits to code that bin
ENT = np.empty(128, np.float32)
ENT[0::2] = -np.log2(1.0 - _P_LPS)
ENT[1::2] = -np.log2(_P_LPS)

# NEXT[s, b] = state after coding bin b in state s = (pstate<<1)|mps
NEXT = np.empty((128, 2), np.int32)
for _s in range(128):
    _ps, _mps = _s >> 1, _s & 1
    for _b in (0, 1):
        if _b == _mps:
            NEXT[_s, _b] = (int(CT.TRANS_IDX_MPS[_ps]) << 1) | _mps
        else:
            _nm = (1 - _mps) if _ps == 0 else _mps
            NEXT[_s, _b] = (int(CT.TRANS_IDX_LPS[_ps]) << 1) | _nm


def _cost_bin(s, b):
    return float(ENT[s ^ b])


# UNARY_COST[prefix][s]: bits for the abs_level>1 unary part — (prefix-1)
# ones + terminating 0 (if prefix<14) in one adapting context + 1 sign
# bypass bit (reference x264_rdo_init, rdo.c:384). Row 0 unused.
UNARY_COST = np.zeros((15, 128), np.float32)
UNARY_TRANS = np.zeros((15, 128), np.int32)
for _p in range(15):
    for _s0 in range(128):
        _s, _bits = _s0, 0.0
        for _i in range(1, _p):
            _bits += _cost_bin(_s, 1)
            _s = int(NEXT[_s, 1])
        if 0 < _p < 14:
            _bits += _cost_bin(_s, 0)
            _s = int(NEXT[_s, 0])
        UNARY_COST[_p, _s0] = _bits + 1.0
        UNARY_TRANS[_p, _s0] = _s

# pixel-domain SSD weights per zigzag position of a 4x4 block: rows of
# the forward transform have squared norms {4,10,4,10}; w2 = 50/(ni*nj)
# (matches x264_dct4_weight2_tab's FIX8(3.125/1.25/0.5) pattern)
_N2 = np.array([4.0, 10.0, 4.0, 10.0])
_W2_RASTER = 50.0 / (_N2[:, None] * _N2[None, :])          # [4,4]
W2_ZIG4 = _W2_RASTER.reshape(16)[tables.ZIGZAG4_FRAME].astype(np.float32)

# unquant_mf: direct .8 fixed-point inverse of the forward quant scale
# (NOT the spec dequant — reference set.c unquant4_mf), per qp, per
# zigzag position
UNQ4_ZIG = np.empty((64, 16), np.int32)
for _qp in range(64):
    _mf = tables.QUANT4_MF[_qp % 6].reshape(16).astype(np.int64)
    _unq = ((1 << (_qp // 6 + 15 + 8)) + _mf // 2) // _mf
    UNQ4_ZIG[_qp] = _unq[tables.ZIGZAG4_FRAME]

# trellis lambda2 in our float units. Reference units: score =
# d^2 * FIX8(w) + bits*256 * lam2_tab >> 4 with lam2_tab =
# c^2 * 2^(qp/3 + 10 - LAMBDA_BITS=4). Dividing the whole score by 256
# (our w2 = FIX8(w)/256): bits term = bits * c^2 * 2^(qp/3+10) / 256 =
# bits * c^2 * 2^(qp/3 + 2).
LAM2_INTER = (0.85 ** 2 * 2.0 ** (np.arange(64) / 3.0 + 2.0)
              ).astype(np.float32)
LAM2_INTRA = (0.65 ** 2 * 2.0 ** (np.arange(64) / 3.0 + 2.0)
              ).astype(np.float32)

# node machine (8-state summary of spec 9.3.3.1.3 ctxIdxInc rules for
# coeff_abs_level_minus1; same layout as rdo.c trellis_coef1_*/coefn_*)
_T1 = np.array([1, 2, 3, 3, 4, 5, 6, 7], np.int32)     # target after L==1
_TN = np.array([4, 4, 4, 4, 5, 6, 7, 7], np.int32)     # target after L>1
_L1CTX = np.array([1, 2, 3, 4, 0, 0, 0, 0], np.int32)  # bin0 ctx per node
# gt1 ctx per source node (9 = luma levelgt1; chroma-dc passes 8)
_GT1CTX_LUMA = np.array([5, 5, 5, 5, 6, 7, 8, 9], np.int32)

_INF = np.float32(1e30)

# context family bases (clause 9.3.3.1.3 / Table 9-40), as in
# native/cabac.cpp:157-159
SIG_OFF = [105 + 0, 105 + 15, 105 + 29, 105 + 44, 105 + 47]
LAST_OFF = [166 + 0, 166 + 15, 166 + 29, 166 + 44, 166 + 47]
LVL_OFF = [227 + 0, 227 + 10, 227 + 20, 227 + 30, 227 + 39]


def frame_ctx_costs(slice_type_i: bool, slice_qp: int, cat: int,
                    model: int = 0):
    """Host-side per-frame constants: sig/last flag costs per position
    (from slice-init states; flags use one fixed context per position in
    4x4 blocks so no adaptation is needed — rdo.c comment at :757) and
    the 10 packed init states of the abs-level context family.

    Returns (sig_cost [16,2] f32, last_cost [16,2] f32,
             lvl_states [10] int32)."""
    from ..entropy.cabac_host import init_states
    pstate, mps = init_states(slice_type_i, slice_qp, model)
    packed = (pstate.astype(np.int32) << 1) | mps.astype(np.int32)
    sig = np.zeros((16, 2), np.float32)
    last = np.zeros((16, 2), np.float32)
    for i in range(15):                      # position 15 has no flags
        s = packed[SIG_OFF[cat] + i]
        sl = packed[LAST_OFF[cat] + i]
        sig[i] = (ENT[s ^ 0], ENT[s ^ 1])
        last[i] = (ENT[sl ^ 0], ENT[sl ^ 1])
    lvl = packed[LVL_OFF[cat]:LVL_OFF[cat] + 10].astype(np.int32)
    return sig, last, lvl


@partial(jax.jit, static_argnames=("b_ac", "dc_block"))
def trellis_4x4(lv_z, w_z, qp, sig_cost, last_cost, lvl_states,
                intra: bool = False, b_ac: int = 0,
                dc_block: bool = False):
    """RD-optimal requantization of deadzone levels (rdo.c:642 as one
    scanned Viterbi over all blocks).

    lv_z    [N,16] int32 signed deadzone levels, zigzag order
    w_z     [N,16] int32 original transform coefficients, zigzag order
    qp      [N]    int32 per-block QP (per-MB AQ aware)
    sig_cost/last_cost [16,2] f32, lvl_states [10] int32
            (from frame_ctx_costs)
    Returns ([N,16] int32 re-quantized signed levels in zigzag order,
             [N] f32 winning RD score — tests check it against an
             independent exact scorer).
    """
    N = lv_z.shape[0]
    q_abs = jnp.abs(lv_z)
    c_abs = jnp.abs(w_z).astype(jnp.float32)
    sgn = jnp.sign(w_z)

    unq = jnp.asarray(UNQ4_ZIG)[qp]                       # [N,16]
    lam_tab = jnp.asarray(LAM2_INTRA if intra else LAM2_INTER)
    lam2 = lam_tab[qp]                                    # [N]
    ent = jnp.asarray(ENT)
    nxt = jnp.asarray(NEXT)
    ucost = jnp.asarray(UNARY_COST)
    utrans = jnp.asarray(UNARY_TRANS)
    w2 = jnp.asarray(W2_ZIG4)
    t1 = jnp.asarray(_T1)
    tn = jnp.asarray(_TN)
    gt1ctx = jnp.asarray(_GT1CTX_LUMA)

    # init: node 0 alive; tracked abs-level states = init of ctx
    # {0,4,8,9} for every node
    score0 = jnp.full((N, 8), _INF, jnp.float32).at[:, 0].set(0.0)
    levels0 = jnp.zeros((N, 8, 16), jnp.int32)
    lst0 = jnp.broadcast_to(
        jnp.stack([lvl_states[0], lvl_states[4],
                   lvl_states[8], lvl_states[9]]).astype(jnp.int32),
        (N, 8, 4))

    pos_seq = jnp.arange(15, b_ac - 1, -1, dtype=jnp.int32)

    def step(carry, i):
        score, levels, lst = carry
        q = q_abs[:, i]                                   # [N]
        c = c_abs[:, i]
        u = unq[:, i]                                     # [N] int32
        wgt = w2[i]
        sc0 = sig_cost[i, 0]
        sc1 = sig_cost[i, 1]
        lc0 = last_cost[i, 0]
        lc1 = last_cost[i, 1]

        cand_L = jnp.stack([jnp.maximum(q - 1, 0), q], axis=1)  # [N,2]
        dq_i = (u[:, None] * cand_L + 128) >> 8
        dq = dq_i.astype(jnp.float32)                           # [N,2]
        d = c[:, None] - dq
        ssd = d * d * wgt                                       # [N,2]
        if not dc_block and b_ac == 0:
            # DC rounding optimization for DC-only blocks
            # (rdo.c:838: recon rounds DC to a multiple of 16)
            dqr = (((dq_i + 8) >> 4) << 4).astype(jnp.float32)
            d0 = c[:, None] - dqr
            ssd_dconly = d0 * d0 * wgt
            is_dc_pos = (i == 0)
            ssd_n0 = jnp.where(is_dc_pos, ssd_dconly, ssd)
        else:
            ssd_n0 = ssd
        is_zero = cand_L == 0                                   # [N,2]
        gt1 = (cand_L > 1).astype(jnp.int32)                    # [N,2]
        prefix = jnp.minimum(cand_L - 1, 14)                    # [N,2]
        # EG0 suffix for abs_level >= 15: 2*floor(log2(L-14)) + 1 bits
        lm = jnp.maximum(cand_L - 14, 1).astype(jnp.float32)
        suffix = jnp.where(cand_L >= 15,
                           2.0 * jnp.floor(jnp.log2(lm)) + 1.0, 0.0)

        # per source node j: bin0 state and gt1 state  [N,8]
        frozen = lvl_states.astype(jnp.int32)
        bin0_st = jnp.stack(
            [jnp.full((N,), frozen[1]), jnp.full((N,), frozen[2]),
             jnp.full((N,), frozen[3]), lst[:, 3, 1],
             lst[:, 4, 0], lst[:, 5, 0], lst[:, 6, 0], lst[:, 7, 0]],
            axis=1)
        gt1_st = jnp.stack(
            [jnp.full((N,), frozen[5]), jnp.full((N,), frozen[5]),
             jnp.full((N,), frozen[5]), jnp.full((N,), frozen[5]),
             jnp.full((N,), frozen[6]), jnp.full((N,), frozen[7]),
             lst[:, 6, 2], lst[:, 7, 3]], axis=1)

        # bits for each (k candidate, j source): [N,2,8]
        bits_bin0 = ent[bin0_st[:, None, :] ^ gt1[:, :, None]]
        bits_un = (ucost[prefix[:, :, None],
                         gt1_st[:, None, :]] + suffix[:, :, None])
        bits_lvl = bits_bin0 + jnp.where(gt1[:, :, None] == 1,
                                         bits_un, 1.0)
        j0 = jnp.arange(8) == 0                                 # [8]
        bits_nz = (sc1 + jnp.where(j0, lc1, lc0)[None, None, :]
                   + bits_lvl)
        bits_z = jnp.where(j0, 0.0, sc0)[None, None, :]
        bits = jnp.where(is_zero[:, :, None], bits_z, bits_nz)

        ssd_jk = jnp.where(j0[None, None, :], ssd_n0[:, :, None],
                           ssd[:, :, None])                     # [N,2,8]
        cand_sc = (score[:, None, :] + ssd_jk
                   + lam2[:, None, None] * bits)                # [N,2,8]

        # transition targets [N,2,8]
        jj = jnp.arange(8)[None, None, :]
        tgt = jnp.where(is_zero[:, :, None], jj,
                        jnp.where((cand_L == 1)[:, :, None],
                                  t1[None, None, :], tn[None, None, :]))

        flat_sc = cand_sc.reshape(N, 16)
        flat_tgt = tgt.reshape(N, 16)
        onehot = flat_tgt[:, :, None] == jnp.arange(8)[None, None, :]
        masked = jnp.where(onehot, flat_sc[:, :, None], _INF)
        new_score = jnp.min(masked, axis=1)                     # [N,8]
        kstar = jnp.argmin(masked, axis=1)                      # [N,8]
        src_j = kstar % 8
        ck = kstar // 8                                         # cand idx
        Lwin = jnp.take_along_axis(cand_L, ck, axis=1)          # [N,8]

        new_levels = jnp.take_along_axis(
            levels, src_j[:, :, None], axis=1)
        new_levels = new_levels.at[:, :, i].set(Lwin)

        new_lst = jnp.take_along_axis(lst, src_j[:, :, None], axis=1)
        # adaptive writes (rdo.c trellis_coef state updates):
        # bin0 transition when src node >= 3 and a level was coded
        b0s = jnp.take_along_axis(bin0_st, src_j, axis=1)       # [N,8]
        g1w = (Lwin > 1).astype(jnp.int32)
        b0n = nxt[b0s, g1w]
        slot_l1 = jnp.where(src_j == 3, 1, 0)
        do_l1 = (src_j >= 3) & (Lwin > 0)
        slots = jnp.arange(4)[None, None, :]
        new_lst = jnp.where(
            (do_l1 & True)[:, :, None]
            & (slots == slot_l1[:, :, None]), b0n[:, :, None], new_lst)
        # gt1 unary transition when landing on node 7 with L > 1
        g1s = jnp.take_along_axis(gt1_st, src_j, axis=1)
        pwin = jnp.take_along_axis(prefix, ck, axis=1)
        g1n = utrans[pwin, g1s]
        node_is7 = jnp.arange(8)[None, :] == 7
        do_g1 = node_is7 & (Lwin > 1)
        slot_g1 = jnp.where(src_j == 6, 2, 3)
        new_lst = jnp.where(
            do_g1[:, :, None] & (slots == slot_g1[:, :, None]),
            g1n[:, :, None], new_lst)
        # dead targets keep dead scores; their levels/states are junk
        # but never read (score stays INF)
        return (new_score, new_levels, new_lst), None

    (score, levels, _), _ = jax.lax.scan(
        step, (score0, levels0, lst0), pos_seq)

    best = jnp.argmin(score, axis=1)                            # [N]
    out = jnp.take_along_axis(levels, best[:, None, None],
                              axis=1)[:, 0]                     # [N,16]
    # node 0 = empty block
    out = jnp.where((best == 0)[:, None], 0, out)
    return out * sgn, jnp.min(score, axis=1)
