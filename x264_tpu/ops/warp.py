"""Per-MB window extraction ("warp").

The subpel refine and MC stages need, for every MB, a small pixel window of
the reference at that MB's own integer motion vector — a data-dependent
gather, the re-expression of the reference's mc.get_ref pointer math
(common/mc.h:269). `mb_windows` is that gather and is what the encoder
uses.

`mb_windows_onehot` computes the same windows as two batched matmuls with
one-hot selection matrices. It is not on the encode path: it is kept so
that chip_smoke.py can time both forms on the GPU (see PERF.md). It runs
only where bf16 dots do; the CPU backend has none.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def mb_windows(planes, off, *, bs: int, win: int, pad: int):
    """Extract per-MB windows from padded planes by gather.

    planes: [P, Hp, Wp] (uint8/int), padded by `pad` px on every side.
    off:    [mbh, mbw, 2] int32 — per-MB (x, y) offset of the window's
            top-left relative to the MB origin.
    Window top-left = (y*bs + pad + off_y, x*bs + pad + off_x).
    Returns [mbh, mbw, P, win, win] int16."""
    P, Hp, Wp = planes.shape
    mbh = (Hp - 2 * pad) // bs
    mbw = (Wp - 2 * pad) // bs
    base_y = (jnp.arange(mbh, dtype=jnp.int32) * bs)[:, None] + pad \
        + off[:, :, 1]
    base_x = (jnp.arange(mbw, dtype=jnp.int32) * bs)[None, :] + pad \
        + off[:, :, 0]
    ar = jnp.arange(win, dtype=jnp.int32)
    rows = base_y[:, :, None, None] + ar[None, None, :, None]
    cols = base_x[:, :, None, None] + ar[None, None, None, :]
    return planes[:, rows, cols].transpose(1, 2, 0, 3, 4).astype(jnp.int16)


def mb_windows_onehot(planes, off, *, bs: int, lo: int, hi: int,
                      win: int, pad: int):
    """`mb_windows` as one-hot matmuls; each offset must lie in [lo, hi].

    Exact: pixel values 0..255 are exact in bfloat16 and each output is
    one 1.0 times one pixel, accumulated in float32.

    Windows are banded — MB (y, x) reads rows [y*bs + off_y + lo, ...
    + win) and cols [x*bs + off_x + lo, ... + win) with off in [lo, hi],
    so the column selection touches only a few adjacent bs-wide blocks
    (one shifted block view + a small one-hot per block shift) and the
    row selection stays within a band of (hi - lo + win) rows.
    """
    P, Hp, Wp = planes.shape
    mbh = (Hp - 2 * pad) // bs
    mbw = (Wp - 2 * pad) // bs
    band = hi - lo + win
    rel_max = hi + win - 1
    dlo = lo // bs if lo >= 0 else -((-lo + bs - 1) // bs)
    dhi = rel_max // bs
    assert pad + dlo * bs >= 0, (pad, dlo, bs)
    assert pad + dhi * bs + mbw * bs <= Wp, (pad, dhi, mbw, bs, Wp)

    # --- row bands: [mbh, P, band, Wp] ---
    bands = jnp.stack([
        jax.lax.dynamic_slice(planes, (0, i * bs + pad + lo, 0),
                              (P, band, Wp)) for i in range(mbh)])
    bands = bands.astype(jnp.bfloat16)

    # --- column (lane) selection: per block-shift delta, a small one-hot
    # einsum against the delta-shifted block view of the band ---
    xs_k = jnp.arange(win, dtype=jnp.int32)
    rel_col = off[:, :, 0:1] + xs_k[None, None, :]        # [mbh, mbw, win]
    s_ar = jnp.arange(bs, dtype=jnp.int32)
    Q = None
    for d in range(dlo, dhi + 1):
        # block view: cols pad + d*bs + [0, mbw*bs) -> [mbh,P,band,mbw,bs]
        bv = bands[:, :, :, pad + d * bs: pad + d * bs + mbw * bs]
        bv = bv.reshape(mbh, P, band, mbw, bs)
        sel = (rel_col[:, :, None, :] == (d * bs + s_ar)[None, None, :,
                                                         None])
        Sd = sel.astype(jnp.bfloat16)                     # [mbh,mbw,bs,win]
        q = jnp.einsum("bphms,bmsk->bphmk", bv, Sd,
                       preferred_element_type=jnp.float32)
        Q = q if Q is None else Q + q
    Q = Q.astype(jnp.bfloat16)                            # [mbh,P,band,mbw,win]

    # --- row selection ---
    r_ar = jnp.arange(win, dtype=jnp.int32)
    rel_row = off[:, :, 1:2] - lo + r_ar[None, None, :]   # [mbh, mbw, win]
    b_ar = jnp.arange(band, dtype=jnp.int32)
    T = (rel_row[:, :, :, None] == b_ar[None, None, None, :]) \
        .astype(jnp.bfloat16)                             # [mbh,mbw,win,band]
    out = jnp.einsum("bmrh,bphmk->bmprk", T, Q,
                     preferred_element_type=jnp.float32)
    return out.astype(jnp.int16)                          # [mbh,mbw,P,win,win]
