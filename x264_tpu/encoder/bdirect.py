"""B_Direct_16x16 / B_Skip: spatial direct motion derivation.

Reference analogue: mb_predict_mv_direct16x16_spatial (mvpred.c:290) +
the B_Skip/B_Direct decision in analyse.c:1844+. Batched form: the
derivation reads only already-decided neighbor fields, so it runs as a
batched shifted-neighbor pass; because a direct MB's own MV feeds later
MBs' derivations, adoption runs as a bounded FIXED-POINT loop: derive ->
adopt where cheaper -> re-derive -> revert any MB whose derivation
changed, until the field is self-consistent (conformance demands that a
decoder deriving from the final coded fields reproduces exactly the MVs
the encoder predicted with; the loop enforces that invariant by
construction, reverting unstable MBs to their explicit modes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

MODE_L0, MODE_L1, MODE_BI, MODE_DIRECT = 0, 1, 2, 3


def _shift_l(a):
    return jnp.concatenate([jnp.zeros_like(a[:, :1]), a[:, :-1]], axis=1)


def _shift_u(a):
    return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)


def _shift_ur(a):
    up = _shift_u(a)
    return jnp.concatenate([up[:, 1:], jnp.zeros_like(up[:, :1])], axis=1)


def _shift_ul(a):
    return _shift_l(_shift_u(a))


def derive_direct(use0, use1, mv0, mv1, col_inter, col_mv):
    """Spatial direct derivation for every MB (mvpred.c:290, 16x16,
    1 ref per list, progressive).

    use0/use1 [mbh,mbw] bool — neighbor fields' refIdxLX == 0;
    mv0/mv1 [mbh,mbw,2] — per-list MVs (0 where unused, the cache
    convention); col_inter [mbh,mbw] — the L1 anchor's colocated MB has
    ref0 == 0; col_mv — its MV.
    Returns (d_use0, d_use1, d_mv0, d_mv1)."""
    mbh, mbw = use0.shape
    col = jnp.arange(mbw)[None, :]
    row = jnp.arange(mbh)[:, None]
    avail_a = jnp.broadcast_to(col > 0, (mbh, mbw))
    avail_b = jnp.broadcast_to(row > 0, (mbh, mbw))
    avail_c = avail_b & (col < mbw - 1)
    avail_d = avail_a & avail_b

    outs = []
    for use, mv in ((use0, mv0), (use1, mv1)):
        mvm = jnp.where(use[..., None], mv, 0)
        mv_a = jnp.where(avail_a[..., None], _shift_l(mvm), 0)
        mv_b = jnp.where(avail_b[..., None], _shift_u(mvm), 0)
        ref_a = avail_a & _shift_l(use)
        ref_b = avail_b & _shift_u(use)
        # C with positional D fallback (out-of-frame only, refc == -2)
        mv_c = jnp.where(avail_c[..., None], _shift_ur(mvm),
                         jnp.where(avail_d[..., None], _shift_ul(mvm), 0))
        ref_c = jnp.where(avail_c, _shift_ur(use), avail_d & _shift_ul(use))
        has_ref = ref_a | ref_b | ref_c
        count = (ref_a.astype(jnp.int32) + ref_b.astype(jnp.int32)
                 + ref_c.astype(jnp.int32))
        med = jnp.clip(mv_a, jnp.minimum(mv_b, mv_c),
                       jnp.maximum(mv_b, mv_c))
        only = jnp.where(ref_a[..., None], mv_a,
                         jnp.where(ref_b[..., None], mv_b, mv_c))
        dmv = jnp.where((count > 1)[..., None], med, only)
        dmv = jnp.where(has_ref[..., None], dmv, 0)
        outs.append((has_ref, dmv))
    (u0, m0), (u1, m1) = outs

    # ref[0] < 0 && ref[1] < 0 -> both lists ref 0, zero MVs
    none_ref = ~u0 & ~u1
    u0 = u0 | none_ref
    u1 = u1 | none_ref
    m0 = jnp.where(none_ref[..., None], 0, m0)
    m1 = jnp.where(none_ref[..., None], 0, m1)

    # col_zero: colocated L1-anchor MB is inter ref0 with |mv| <= 1
    colzero = (col_inter
               & (jnp.abs(col_mv[..., 0]) <= 1)
               & (jnp.abs(col_mv[..., 1]) <= 1)
               & ~none_ref)
    mv_nonzero = jnp.any(m0 != 0, axis=-1) | jnp.any(m1 != 0, axis=-1)
    apply_cz = colzero & mv_nonzero
    m0 = jnp.where((apply_cz & u0)[..., None], 0, m0)
    m1 = jnp.where((apply_cz & u1)[..., None], 0, m1)
    return u0, u1, m0, m1


def direct_pred_luma(hpel, dmv, mbh, mbw):
    """Luma MC at an arbitrary per-MB qpel MV via warp windows + one-hot
    phase selection (the per-MB-dynamic-phase form of refine_subpel's
    static candidate slices). Returns pred [n,16,16] int32."""
    from ..ops import mc
    from ..ops.warp import mb_windows
    n = mbh * mbw
    M = 2
    WW = 16 + 2 * M + 1
    fp = (dmv >> 2).reshape(mbh, mbw, 2)          # floor full-pel part
    win = mb_windows(hpel, fp - M, bs=16, win=WW, pad=mc.PAD)
    win = win.reshape(n, 4, WW, WW).astype(jnp.int32)
    fx = (dmv[:, 0] & 3).astype(jnp.int32)
    fy = (dmv[:, 1] & 3).astype(jnp.int32)
    phase = fy * 4 + fx                            # [n]
    pred = jnp.zeros((n, 16, 16), jnp.int32)
    for q in range(16):
        pfx, pfy = q & 3, q >> 2
        p0 = int(mc.HPEL_REF0[q])
        p1 = int(mc.HPEL_REF1[q])
        oy0 = 1 if pfy == 3 else 0
        s0 = win[:, p0, M + oy0:M + oy0 + 16, M:M + 16]
        if q & 5:
            ox1 = 1 if pfx == 3 else 0
            s1 = win[:, p1, M:M + 16, M + ox1:M + ox1 + 16]
            pq = (s0 + s1 + 1) >> 1
        else:
            pq = s0
        pred = jnp.where((phase == q)[:, None, None], pq, pred)
    return pred
