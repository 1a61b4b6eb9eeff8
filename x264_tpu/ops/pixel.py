"""Pixel comparison metrics: SAD / SSD / SATD / SA8D / variance / SSIM.

Reference op table: common/pixel.h:78-144 (x264_pixel_function_t).
All ops batched over leading dims; blocks are [..., h, w]. The
multi-candidate versions (sad_x4 etc.) are just larger batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_H4 = np.array([[1, 1, 1, 1],
                [1, -1, 1, -1],
                [1, 1, -1, -1],
                [1, -1, -1, 1]], dtype=np.int32)


@jax.jit
def sad(a, b):
    """Sum of absolute differences over the last 2 dims."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    return jnp.sum(jnp.abs(d), axis=(-2, -1))


@jax.jit
def ssd(a, b):
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    return jnp.sum(d * d, axis=(-2, -1))


def _hadamard_dist4(d):
    """sum |H d H| over 4x4 tiles; d [..., 4, 4] int32."""
    h = jnp.asarray(_H4)
    t = jnp.einsum("ij,...jk,lk->...il", h, d, h,
                   preferred_element_type=jnp.int32)
    return jnp.sum(jnp.abs(t), axis=(-2, -1))


@jax.jit
def satd(a, b):
    """SATD over blocks whose h,w are multiples of 4 (x264 semantics:
    sum of 4x4 Hadamard transforms of the difference, halved)."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    hh, ww = d.shape[-2], d.shape[-1]
    d = d.reshape(d.shape[:-2] + (hh // 4, 4, ww // 4, 4))
    d = d.swapaxes(-3, -2)            # [..., th, tw, 4, 4]
    s = _hadamard_dist4(d)
    return jnp.sum(s, axis=(-2, -1)) >> 1


@jax.jit
def sa8d(a, b):
    """SA8D: 8x8 Hadamard distortion (x264: (sum+2)>>2 normalization)."""
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    hh, ww = d.shape[-2], d.shape[-1]
    d = d.reshape(d.shape[:-2] + (hh // 8, 8, ww // 8, 8))
    d = d.swapaxes(-3, -2)
    h8 = jnp.asarray(np.kron(_H4[:2, :2], np.kron(_H4[:2, :2], _H4[:2, :2]))
                     .astype(np.int32))
    t = jnp.einsum("ij,...jk,lk->...il", h8, d, h8,
                   preferred_element_type=jnp.int32)
    s = (jnp.sum(jnp.abs(t), axis=(-2, -1)) + 2) >> 2
    return jnp.sum(s, axis=(-2, -1))


@jax.jit
def var(a):
    """(sum, ssq) -> x264 var: ssq - sum^2/n over the block."""
    x = a.astype(jnp.int32)
    s = jnp.sum(x, axis=(-2, -1))
    sq = jnp.sum(x * x, axis=(-2, -1))
    n = a.shape[-1] * a.shape[-2]
    return sq - (s * s) // n


@jax.jit
def avg_pixel(a, b):
    """Rounded average (bipred): (a+b+1)>>1."""
    return (a.astype(jnp.int32) + b.astype(jnp.int32) + 1) >> 1


# ---------------------------------------------------------- numpy reference
def sad_np(a, b):
    return np.abs(np.asarray(a, np.int64)
                  - np.asarray(b, np.int64)).sum(axis=(-2, -1))


def ssd_np(a, b):
    d = np.asarray(a, np.int64) - np.asarray(b, np.int64)
    return (d * d).sum(axis=(-2, -1))


def satd_np(a, b):
    d = np.asarray(a, np.int64) - np.asarray(b, np.int64)
    hh, ww = d.shape[-2:]
    total = np.zeros(d.shape[:-2], np.int64)
    for i in range(0, hh, 4):
        for j in range(0, ww, 4):
            blk = d[..., i:i + 4, j:j + 4]
            t = np.einsum("ij,...jk,lk->...il", _H4, blk, _H4)
            total += np.abs(t).sum(axis=(-2, -1))
    return total >> 1


# x264 SSIM constants (pixel.c ssim_end1: .01/.03 on 64-px windows)
_SSIM_C1 = int(0.01 * 0.01 * 255 * 255 * 64 + 0.5)
_SSIM_C2 = int(0.03 * 0.03 * 255 * 255 * 64 * 63 / 64 + 0.5)


@jax.jit
def ssim(a, b):
    """Global SSIM of two planes (reference x264_pixel_ssim_wxh:
    4x4-block sums combined over 2x2 groups, borders cropped)."""
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    H, W = a.shape
    bh, bw = H // 4, W // 4
    ta = a[:bh * 4, :bw * 4].reshape(bh, 4, bw, 4)
    tb = b[:bh * 4, :bw * 4].reshape(bh, 4, bw, 4)
    s1 = ta.sum(axis=(1, 3))
    s2 = tb.sum(axis=(1, 3))
    ss = (ta * ta).sum(axis=(1, 3)) + (tb * tb).sum(axis=(1, 3))
    s12 = (ta * tb).sum(axis=(1, 3))

    def grp(x):
        return (x[:-1, :-1] + x[:-1, 1:] + x[1:, :-1]
                + x[1:, 1:]).astype(jnp.float32)

    g1, g2, gss, g12 = grp(s1), grp(s2), grp(ss), grp(s12)
    vars_ = gss * 64 - g1 * g1 - g2 * g2
    covar = g12 * 64 - g1 * g2
    v = ((2 * g1 * g2 + _SSIM_C1) * (2 * covar + _SSIM_C2)
         / ((g1 * g1 + g2 * g2 + _SSIM_C1) * (vars_ + _SSIM_C2)))
    return jnp.mean(v)
