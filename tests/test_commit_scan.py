"""The wavefront commit scan (intra.commit_scan) against an independent
raster-order reference.

The reference walks the MBs one by one in raster order, as a decoder
does: intra predictors, dequant, inverse transforms and recon come from
the spec decoder tools/refdec.py; the forward transform and quantizer are
the numpy twins in ops/ (x264's deadzone formulas, intra rounding). Every
level and every recon sample must match exactly."""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import jax.numpy as jnp  # noqa: E402
import refdec  # noqa: E402

from x264_tpu.encoder.intra import (commit_scan, decide_modes,  # noqa: E402
                                    decide_modes_i4)
from x264_tpu.ops import tables  # noqa: E402
from x264_tpu.ops.dct import dct4x4_np, hadamard4x4_np  # noqa: E402
from x264_tpu.ops.quant import quant4x4_np  # noqa: E402
from x264_tpu.ops.tables import chroma_qp  # noqa: E402

ZIG = refdec.ZIG4          # scan index -> raster position in a 4x4 block


def _dc_quant(h, qp):
    """Intra DC quant of a Hadamard output (luma 4x4 or chroma 2x2)."""
    h = np.asarray(h, np.int64)
    qbits = 16 + qp // 6
    f = (21 << qbits) >> 6
    mf = int(tables.QUANT4_SCALE[qp % 6, 0])
    return np.sign(h) * ((np.abs(h) * mf + f) >> qbits)


def _blocks(res, n):
    """[4n, 4n] residual -> {raster index: 4x4 block} for an n x n grid."""
    return {by * n + bx: res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4]
            for by in range(n) for bx in range(n)}


def _chroma_levels(dec, plane, src, mx, my, cmode, qpc):
    """Chroma DC [4] and AC [4, 4, 4] (raster blocks, pos 0 zero)."""
    pred = dec.predc(cmode, plane, mx, my)
    res = src[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8].astype(np.int64) - pred
    w = {k: dct4x4_np(b) for k, b in _blocks(res, 2).items()}
    a, b, c, d = (int(w[k][0, 0]) for k in range(4))
    had = np.array([[a + b + c + d, a - b + c - d],
                    [a + b - c - d, a - b - c + d]])
    dc = _dc_quant(had, qpc).reshape(4)
    ac = np.stack([quant4x4_np(w[k], qpc) for k in range(4)]).astype(
        np.int64)
    ac[:, 0, 0] = 0
    return dc, ac


def reference_commit(y, u, v, i16_mode, chroma_mode, qp_mb, i4_mask=None,
                     i4_modes=None, is_intra=None, inter_planes=None):
    """Raster-order encode of every MB; returns (levels dict, recon)."""
    H, W = y.shape
    mbh, mbw = H // 16, W // 16
    dec = refdec.Decoder()
    dec.sps = SimpleNamespace(mb_w=mbw)
    dec.pps = SimpleNamespace(chroma_qp_index_offset=0)
    ry = np.zeros((H, W), np.int64)
    ru = np.zeros((H // 2, W // 2), np.int64)
    rv = np.zeros_like(ru)
    n = mbw * mbh
    lv = {"dc": np.zeros((n, 4, 4), np.int64),
          "ac": np.zeros((n, 16, 4, 4), np.int64),
          "udc": np.zeros((n, 2, 2), np.int64),
          "uac": np.zeros((n, 4, 4, 4), np.int64),
          "vdc": np.zeros((n, 2, 2), np.int64),
          "vac": np.zeros((n, 4, 4, 4), np.int64)}
    for my in range(mbh):
        for mx in range(mbw):
            m = my * mbw + mx
            ys, xs = slice(my * 16, my * 16 + 16), slice(mx * 16, mx * 16 + 16)
            cys, cxs = slice(my * 8, my * 8 + 8), slice(mx * 8, mx * 8 + 8)
            if is_intra is not None and not is_intra[my, mx]:
                ry[ys, xs] = inter_planes[0][ys, xs]
                ru[cys, cxs] = inter_planes[1][cys, cxs]
                rv[cys, cxs] = inter_planes[2][cys, cxs]
                continue
            qp = int(qp_mb[my, mx])
            qpc = int(refdec.CHROMA_QP[qp])
            cmode = int(chroma_mode[my, mx])
            udc, uac = _chroma_levels(dec, ru, u, mx, my, cmode, qpc)
            vdc, vac = _chroma_levels(dec, rv, v, mx, my, cmode, qpc)
            lv["udc"][m], lv["uac"][m] = udc.reshape(2, 2), uac
            lv["vdc"][m], lv["vac"][m] = vdc.reshape(2, 2), vac
            cdc = np.stack([udc, vdc])
            cac = np.stack([uac.reshape(4, 16)[:, ZIG],
                            vac.reshape(4, 16)[:, ZIG]])
            if i4_mask is not None and i4_mask[my, mx]:
                modes = np.asarray(i4_modes[my, mx])
                for z in range(16):
                    bx, by = int(refdec.ZBLK_X[z]), int(refdec.ZBLK_Y[z])
                    r = by * 4 + bx
                    left4, top8, tl, al, at = dec._i4_block_neighbors(
                        ry, mx, my, bx, by, mbw)
                    pred = dec._pred4x4(int(modes[r]), left4, top8, tl,
                                        al, at)
                    py, px = my * 16 + by * 4, mx * 16 + bx * 4
                    res = y[py:py + 4, px:px + 4].astype(np.int64) - pred
                    blk = quant4x4_np(dct4x4_np(res), qp)
                    lv["ac"][m, r] = blk
                    rec = refdec.idct4(refdec.dequant4(
                        blk.reshape(16)[ZIG].astype(np.int64), qp))
                    ry[py:py + 4, px:px + 4] = np.clip(pred + rec, 0, 255)
                dec._recon_chroma_arrays(ru, rv, mx, my, cmode, qp, cdc,
                                         cac)
                continue
            mode = int(i16_mode[my, mx])
            pred = dec.pred16(mode, ry, mx, my)
            res = y[ys, xs].astype(np.int64) - pred
            w = {k: dct4x4_np(b) for k, b in _blocks(res, 4).items()}
            grid = np.array([[w[by * 4 + bx][0, 0] for bx in range(4)]
                             for by in range(4)], np.int64)
            dc = _dc_quant(hadamard4x4_np(grid) >> 1, qp)
            ac = np.stack([quant4x4_np(w[k], qp) for k in range(16)]) \
                .astype(np.int64)
            ac[:, 0, 0] = 0
            lv["dc"][m], lv["ac"][m] = dc, ac
            dec._recon_i16_arrays(ry, ru, rv, mx, my, mode, cmode, qp,
                                  dc.reshape(16)[ZIG],
                                  ac.reshape(16, 16)[:, ZIG], cdc, cac)
    return lv, (ry, ru, rv)


def _content(w, h, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    # smooth structure + noise, so predictors and residuals both matter
    y = np.clip(128 + 60 * np.sin(xx / 7.0 + seed) * np.cos(yy / 5.0)
                + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.uint8)
    u = rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
    v = rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
    return y, u, v


def _assert_same(got, ref):
    coeffs, recon = got
    ref_lv, ref_recon = ref
    for k, want in ref_lv.items():
        np.testing.assert_array_equal(
            np.asarray(coeffs[k]).reshape(want.shape), want, err_msg=k)
    for i in range(3):
        np.testing.assert_array_equal(np.asarray(recon[i]), ref_recon[i],
                                      err_msg=f"recon plane {i}")


def _inputs(w, h, seed, qp_lo, qp_hi):
    y, u, v = _content(w, h, seed)
    mbw, mbh = w // 16, h // 16
    rng = np.random.default_rng(100 + seed)
    qp_mb = rng.integers(qp_lo, qp_hi, (mbh, mbw)).astype(np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb), np.int32)
    i16, cm, _ = decide_modes(jnp.asarray(y), jnp.asarray(u),
                              jnp.asarray(v))
    return y, u, v, qp_mb, qpc_mb, np.asarray(i16), np.asarray(cm), rng


@pytest.mark.parametrize("seed", [0, 7])
def test_commit_scan_i16(seed):
    w, h = 48, 32                    # mbw=3, mbh=2
    y, u, v, qp_mb, qpc_mb, i16, cm, _ = _inputs(w, h, seed, 12, 44)
    got = commit_scan(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(i16), jnp.asarray(cm), jnp.asarray(qp_mb),
                      jnp.asarray(qpc_mb), w // 16, h // 16)
    _assert_same(got, reference_commit(y, u, v, i16, cm, qp_mb))


@pytest.mark.parametrize("mixed", [False, True])
def test_commit_scan_i4(mixed):
    """I_4x4 z-scan lanes (the default-preset path), alone and mixed with
    inter MBs (intra-in-P)."""
    w, h = 64, 48                    # mbw=4, mbh=3
    y, u, v, qp_mb, qpc_mb, i16, cm, rng = _inputs(w, h, 11, 14, 42)
    i4_modes = np.asarray(decide_modes_i4(jnp.asarray(y))[0])
    i4_mask = rng.integers(0, 2, (h // 16, w // 16)).astype(bool)
    kw, ref_kw = {}, {}
    if mixed:
        inter = _content(w, h, 13)
        is_intra = rng.integers(0, 2, (h // 16, w // 16)).astype(bool) \
            | i4_mask
        kw = dict(is_intra=jnp.asarray(is_intra),
                  inter_planes=[jnp.asarray(p) for p in inter])
        ref_kw = dict(is_intra=is_intra, inter_planes=inter)
    got = commit_scan(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(i16), jnp.asarray(cm), jnp.asarray(qp_mb),
                      jnp.asarray(qpc_mb), w // 16, h // 16,
                      i4_mask=jnp.asarray(i4_mask),
                      i4_modes=jnp.asarray(i4_modes), **kw)
    _assert_same(got, reference_commit(y, u, v, i16, cm, qp_mb,
                                       i4_mask=i4_mask, i4_modes=i4_modes,
                                       **ref_kw))


def test_commit_scan_mixed():
    """Mixed intra/inter lanes, I16 only (the intra-in-P path)."""
    w, h = 48, 32
    y, u, v, _, _, i16, cm, _ = _inputs(w, h, 3, 28, 29)
    qp_mb = np.full((h // 16, w // 16), 28, np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb), np.int32)
    inter = _content(w, h, 4)
    is_intra = np.random.default_rng(5).integers(
        0, 2, (h // 16, w // 16)).astype(bool)
    got = commit_scan(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                      jnp.asarray(i16), jnp.asarray(cm), jnp.asarray(qp_mb),
                      jnp.asarray(qpc_mb), w // 16, h // 16,
                      is_intra=jnp.asarray(is_intra),
                      inter_planes=[jnp.asarray(p) for p in inter])
    _assert_same(got, reference_commit(y, u, v, i16, cm, qp_mb,
                                       is_intra=is_intra,
                                       inter_planes=inter))
