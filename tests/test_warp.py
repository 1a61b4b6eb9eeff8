"""Per-MB window extraction (ops/warp.mb_windows) against a plain numpy
loop, at the window shapes of its three call sites: subpel refine
(inter._subpel_windows), chroma MC (inter.chroma_mc_warp) and B direct
luma MC (bdirect.direct_pred_luma)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from x264_tpu.encoder.inter import SUBPEL_MARG, SUBPEL_WIN  # noqa: E402
from x264_tpu.ops import mc  # noqa: E402
from x264_tpu.ops.warp import mb_windows  # noqa: E402

R = 16                      # preset medium --merange
SITES = {   # name: (planes, bs, lo, hi, win, pad)
    "subpel": (4, 16, -R - SUBPEL_MARG, R - SUBPEL_MARG, SUBPEL_WIN,
               mc.PAD),
    "chroma_mc": (2, 8, -((4 * R + 3 + 7) >> 3), (4 * R + 3) >> 3, 9,
                  mc.CPAD),
    "bdirect": (4, 16, -R - 2, R - 2, 21, mc.PAD),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_mb_windows_matches_loop(site):
    P, bs, lo, hi, win, pad = SITES[site]
    mbw, mbh = 3, 2
    rng = np.random.default_rng(len(site))
    planes = rng.integers(0, 256, (P, mbh * bs + 2 * pad,
                                   mbw * bs + 2 * pad)).astype(np.uint8)
    off = rng.integers(lo, hi + 1, (mbh, mbw, 2)).astype(np.int32)
    off[0, 0] = (lo, lo)                 # both extremes of the range
    off[-1, -1] = (hi, hi)
    got = np.asarray(mb_windows(jnp.asarray(planes), jnp.asarray(off),
                                bs=bs, win=win, pad=pad))
    assert got.shape == (mbh, mbw, P, win, win)
    for my in range(mbh):
        for mx in range(mbw):
            y0 = my * bs + pad + off[my, mx, 1]
            x0 = mx * bs + pad + off[my, mx, 0]
            for p in range(P):
                np.testing.assert_array_equal(
                    got[my, mx, p], planes[p, y0:y0 + win, x0:x0 + win],
                    err_msg=f"{site} MB ({mx},{my}) plane {p}")
