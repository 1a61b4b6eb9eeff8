"""Quantization / dequantization ops.

Reference op table: common/quant.h:30-70 (x264_quant_function_t); tables
common/set.c:31-71 (x264_cqm_init). Dequant follows H.264 spec 8.5.10-8.5.13
exactly (conformance-critical); forward quant is the JM/x264-style deadzone
quantizer (encoder freedom).

All ops are batched over leading dims and accept `qp` as a scalar or an array
broadcastable against the batch (per-MB adaptive QP). int32 throughout —
safe for 8-bit depth (JAX runs without x64 by default).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import tables


def _bc_qp(qp, batch_shape):
    """Broadcast qp to [batch..., 1, 1] int32."""
    q = jnp.asarray(qp, dtype=jnp.int32)
    q = jnp.broadcast_to(q, batch_shape)
    return q[..., None, None]


# ------------------------------------------------------------------ 4x4 AC
@partial(jax.jit, static_argnames=("intra", "deadzone"))
def quant4x4(w, qp, intra: bool = True, deadzone=None):
    """Deadzone quant of 4x4 coeffs [..., 4, 4] -> levels int32.

    deadzone: rounding offset in 1/64 units (x264 default 21 intra/11 inter).
    """
    if deadzone is None:
        deadzone = 21 if intra else 11
    q = _bc_qp(qp, w.shape[:-2])
    mf = jnp.asarray(tables.QUANT4_MF)[q[..., 0, 0] % 6]         # [...,4,4]
    qbits = 15 + q // 6
    f = (deadzone << qbits) >> 6
    aw = jnp.abs(w.astype(jnp.int32))
    level = (aw * mf + f) >> qbits
    return jnp.sign(w) * level


@jax.jit
def dequant4x4(levels, qp):
    """Spec 8.5.12.1 dequant of 4x4 AC (flat CQM)."""
    q = _bc_qp(qp, levels.shape[:-2])
    mf16 = jnp.asarray(tables.DEQUANT4_MF)[q[..., 0, 0] % 6] << 4
    shift = q // 6 - 4
    l32 = levels.astype(jnp.int32) * mf16
    pos = l32 << jnp.maximum(shift, 0)
    rnd = jnp.where(shift < 0, 1 << jnp.maximum(-shift - 1, 0), 0)
    neg = (l32 + rnd) >> jnp.maximum(-shift, 0)
    return jnp.where(shift >= 0, pos, neg)


# ------------------------------------------------------------ I16x16 luma DC
@partial(jax.jit, static_argnames=("deadzone",))
def quant4x4_dc(h, qp, deadzone: int = 21):
    """Quant of the 4x4 Hadamard of luma DCs (gain-4 hadamard -> qbits+1)."""
    q = _bc_qp(qp, h.shape[:-2])
    mf00 = jnp.asarray(tables.QUANT4_SCALE)[q % 6, 0]
    qbits = 16 + q // 6
    f = (deadzone << qbits) >> 6
    ah = jnp.abs(h.astype(jnp.int32))
    level = (ah * mf00 + f) >> qbits
    return jnp.sign(h) * level


@jax.jit
def dequant4x4_dc(f, qp):
    """Spec 8.5.10: scale the inverse-hadamard output f -> DC values."""
    q = _bc_qp(qp, f.shape[:-2])
    mf16 = (jnp.asarray(tables.DEQUANT4_SCALE)[q % 6, 0] << 4)
    per = q // 6
    l32 = f.astype(jnp.int32) * mf16
    pos = l32 << jnp.maximum(per - 6, 0)
    rnd = 1 << jnp.maximum(5 - per, 0)
    neg = (l32 + rnd) >> jnp.maximum(6 - per, 0)
    return jnp.where(per >= 6, pos, neg)


# ------------------------------------------------------------- chroma 2x2 DC
@partial(jax.jit, static_argnames=("intra", "deadzone"))
def quant2x2_dc(h, qp, intra: bool = True, deadzone=None):
    if deadzone is None:
        deadzone = 21 if intra else 11
    q = _bc_qp(qp, h.shape[:-2])
    mf00 = jnp.asarray(tables.QUANT4_SCALE)[q % 6, 0]
    qbits = 16 + q // 6
    f = (deadzone << qbits) >> 6
    ah = jnp.abs(h.astype(jnp.int32))
    level = (ah * mf00 + f) >> qbits
    return jnp.sign(h) * level


@jax.jit
def dequant2x2_dc(f, qp):
    """Spec 8.5.11: dcC = ((f * LS) << (qp/6)) >> 5, LS = 16*normAdjust00."""
    q = _bc_qp(qp, f.shape[:-2])
    mf16 = (jnp.asarray(tables.DEQUANT4_SCALE)[q % 6, 0] << 4)
    return (f.astype(jnp.int32) * mf16 << (q // 6)) >> 5


# ------------------------------------------------------------------ 8x8 AC
@partial(jax.jit, static_argnames=("intra", "deadzone"))
def quant8x8(w, qp, intra: bool = True, deadzone=None):
    if deadzone is None:
        deadzone = 21 if intra else 11
    q = _bc_qp(qp, w.shape[:-2])
    mf = jnp.asarray(tables.QUANT8_MF)[q[..., 0, 0] % 6]
    qbits = 16 + q // 6
    f = (deadzone << qbits) >> 6
    aw = jnp.abs(w.astype(jnp.int32))
    level = (aw * mf + f) >> qbits
    return jnp.sign(w) * level


@jax.jit
def dequant8x8(levels, qp):
    """Spec 8.5.13.1 dequant of 8x8 (flat CQM)."""
    q = _bc_qp(qp, levels.shape[:-2])
    mf16 = jnp.asarray(tables.DEQUANT8_MF)[q[..., 0, 0] % 6] << 4
    shift = q // 6 - 6
    l32 = levels.astype(jnp.int32) * mf16
    pos = l32 << jnp.maximum(shift, 0)
    rnd = jnp.where(shift < 0, 1 << jnp.maximum(-shift - 1, 0), 0)
    neg = (l32 + rnd) >> jnp.maximum(-shift, 0)
    return jnp.where(shift >= 0, pos, neg)


# ----------------------------------------------- numpy reference (checkasm)
def quant4x4_np(w, qp, intra=True, deadzone=None):
    if deadzone is None:
        deadzone = 21 if intra else 11
    w = np.asarray(w, dtype=np.int64)
    mf = tables.QUANT4_MF[qp % 6].astype(np.int64)
    qbits = 15 + qp // 6
    f = (deadzone << qbits) >> 6
    return (np.sign(w) * ((np.abs(w) * mf + f) >> qbits)).astype(np.int32)


def dequant4x4_np(levels, qp):
    lv = np.asarray(levels, dtype=np.int64)
    mf16 = (tables.DEQUANT4_MF[qp % 6].astype(np.int64)) << 4
    shift = qp // 6 - 4
    if shift >= 0:
        return ((lv * mf16) << shift).astype(np.int32)
    return ((lv * mf16 + (1 << (-shift - 1))) >> (-shift)).astype(np.int32)


def dequant4x4_dc_np(f, qp):
    fv = np.asarray(f, dtype=np.int64)
    mf16 = int(tables.DEQUANT4_SCALE[qp % 6, 0]) << 4
    per = qp // 6
    if per >= 6:
        return ((fv * mf16) << (per - 6)).astype(np.int32)
    return ((fv * mf16 + (1 << (5 - per))) >> (6 - per)).astype(np.int32)


def dequant2x2_dc_np(f, qp):
    fv = np.asarray(f, dtype=np.int64)
    mf16 = int(tables.DEQUANT4_SCALE[qp % 6, 0]) << 4
    return (((fv * mf16) << (qp // 6)) >> 5).astype(np.int32)


def quant8x8_np(w, qp, intra=True, deadzone=None):
    if deadzone is None:
        deadzone = 21 if intra else 11
    w = np.asarray(w, dtype=np.int64)
    mf = tables.QUANT8_MF[qp % 6].astype(np.int64)
    qbits = 16 + qp // 6
    f = (deadzone << qbits) >> 6
    return (np.sign(w) * ((np.abs(w) * mf + f) >> qbits)).astype(np.int32)


def dequant8x8_np(levels, qp):
    lv = np.asarray(levels, dtype=np.int64)
    mf16 = (tables.DEQUANT8_MF[qp % 6].astype(np.int64)) << 4
    shift = qp // 6 - 6
    if shift >= 0:
        return ((lv * mf16) << shift).astype(np.int32)
    return ((lv * mf16 + (1 << (-shift - 1))) >> (-shift)).astype(np.int32)


@jax.jit
def denoise_dct(w, offset):
    """Noise reduction (reference denoise_dct, common/quant.c:304):
    shrink each |coefficient| by a learned per-position offset before
    quantization, and return the per-position |coef| sums that feed the
    offset-learning accumulator.

    w [..., 4, 4] int32 transform coefficients; offset [4, 4] int32.
    Returns (denoised coefficients, |w| position sums [4, 4])."""
    aw = jnp.abs(w.astype(jnp.int32))
    sums = jnp.sum(aw, axis=tuple(range(w.ndim - 2)), dtype=jnp.int64)
    lvl = jnp.maximum(aw - offset.astype(jnp.int32), 0)
    return jnp.sign(w) * lvl, sums


def nr_update(nr_strength: int, sums, count: int, prev_sum, prev_count):
    """Host-side offset learning (reference x264_noise_reduction_update,
    encoder/macroblock.c:1146): exponential-ish accumulator with halving
    past 2^18 samples; offset = nr*count / (sum * weight/256 + 1), DC
    never denoised. The position weight approximates the reference's
    dct4_weight2 table from the dequant class values (derived, not
    transcribed). Returns (offset [4,4] int32, new_sum, new_count)."""
    import numpy as _np
    s = prev_sum + _np.asarray(sums, _np.int64)
    c = prev_count + int(count)
    if c > (1 << 18):
        s >>= 1
        c >>= 1
    d = tables.DEQUANT4_MF[0].astype(_np.int64)          # {10,13,16} classes
    weight2 = (d * d) >> 2
    off = ((_np.int64(nr_strength) * c + s // 2)
           // (s * weight2 // 256 + 1)).astype(_np.int32)
    off[0, 0] = 0
    return off, s, c
