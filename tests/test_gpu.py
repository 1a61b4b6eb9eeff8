"""Checks that need a GPU (marker `gpu`): run them on a GPU host with
`X264_TEST_GPU=1 python -m pytest tests/ -m gpu`; they skip elsewhere."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


def test_gpu_encode_matches_cpu(gpu_device):
    """The encoder on the GPU gives the CPU's bytes and recon."""
    import jax
    cpu = jax.devices("cpu")[0]
    chip_smoke.identity_check(
        gpu_device,
        lambda name, frames: chip_smoke.encode_clip(
            frames, chip_smoke.CONFIGS[name], cpu), 64, 48, 3)


def test_gpu_onehot_windows_match_gather(gpu_device):
    """mb_windows_onehot (bf16 dots; no CPU kernel) == the gather."""
    import jax
    import jax.numpy as jnp

    from x264_tpu.ops.warp import mb_windows, mb_windows_onehot
    rng = np.random.default_rng(0)
    pad, bs, win, lo, hi = 32, 8, 9, -9, 8
    with jax.default_device(gpu_device):
        planes = jnp.asarray(rng.integers(0, 256, (2, 3 * bs + 2 * pad,
                                                   4 * bs + 2 * pad),
                                          dtype=np.uint8))
        off = jnp.asarray(rng.integers(lo, hi + 1, (3, 4, 2),
                                       dtype=np.int32))
        a = mb_windows(planes, off, bs=bs, win=win, pad=pad)
        b = mb_windows_onehot(planes, off, bs=bs, lo=lo, hi=hi, win=win,
                              pad=pad)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
