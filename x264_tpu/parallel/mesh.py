"""Multi-device sharding: the mesh re-expression of the reference's
thread parallelism (SURVEY.md §2.9, doc/threads.txt).

Mapping:
  * mesh axis "stream" — data parallelism over independent frames/streams
    (the encode-farm / frame-threads analogue, dp).
  * mesh axis "band" — spatial parallelism over horizontal slice bands
    within a frame (the sliced-threads analogue, sp/tp). Each band is coded
    as an independent H.264 slice, exactly like x264's sliced threading
    (threaded_slices_write, encoder.c:3219). Slices carry
    disable_deblocking_filter_idc=2 (deblock inside the slice only), so no
    cross-band halo is needed and the assembled stream stays conformant.

All collectives are implicit: shard_map + out_specs keeps every band's
coefficients on its own device until the host entropy gather.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..encoder.intra import encode_iframe_device


def make_mesh(n_devices: int, devices=None) -> Mesh:
    """2D (stream, band) mesh; factorizes n into the two axes.

    `devices` defaults to the default backend's devices. Too few devices
    is an error: a mesh never moves to another backend on its own. A CPU
    dry run passes jax.devices("cpu") explicitly (virtual devices come
    from --xla_force_host_platform_device_count)."""
    if devices is None:
        devices = jax.devices()
    if len(devices) < n_devices:
        raise ValueError(
            f"need {n_devices} devices, have {len(devices)} "
            f"({devices[0].platform if devices else 'none'})")
    devices = devices[:n_devices]
    band = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices > cand:
            band = cand
            break
    stream = n_devices // band
    dev_array = np.array(devices).reshape(stream, band)
    return Mesh(dev_array, ("stream", "band"))


def make_sharded_intra_step(mesh: Mesh, width: int, band_mb_rows: int):
    """Build the jitted multi-device intra encode step.

    Input planes are [B, NB, bandH, W] (+ chroma at half size) with
    B sharded over "stream" and NB (number of bands) over "band".
    slice_qp is passed per (stream, band) so it is not baked into the jit.
    """
    mbw = width // 16
    cap_words = mbw * band_mb_rows * 64

    def band_encode(y, u, v, qp, qpc, slice_qp):
        # local shapes: [b, nb, bandH, W]
        def one(y1, u1, v1, q1, qc1, sq1):
            w, tb, rec, satd, _ = encode_iframe_device(
                y1, u1, v1, q1, qc1, sq1, mbw=mbw, mbh=band_mb_rows,
                cap_words=cap_words)
            return w, tb, rec, satd
        return jax.vmap(jax.vmap(one))(y, u, v, qp, qpc, slice_qp)

    pspec = P("stream", "band")
    step = jax.jit(
        jax.shard_map(
            band_encode, mesh=mesh,
            in_specs=(pspec,) * 6,
            out_specs=pspec,
            check_vma=False,   # scan carry starts unvarying (zeros init)
        ))
    return step


def sharded_intra_encode(mesh: Mesh, planes_batch, qp: int = 26,
                         band_mb_rows: int = 2):
    """Encode a batch of frames data+band parallel; returns device outputs
    (words, total_bits, recon, satd) each leading [B, NB, ...].

    planes_batch: list of [Y,U,V] numpy frames (equal MB-aligned sizes).
    """
    from ..ops.tables import chroma_qp
    B = len(planes_batch)
    H, W = planes_batch[0][0].shape
    nb = H // (band_mb_rows * 16)
    mbw = W // 16
    y = np.stack([f[0] for f in planes_batch]).reshape(
        B, nb, band_mb_rows * 16, W)
    u = np.stack([f[1] for f in planes_batch]).reshape(
        B, nb, band_mb_rows * 8, W // 2)
    v = np.stack([f[2] for f in planes_batch]).reshape(
        B, nb, band_mb_rows * 8, W // 2)
    qp_mb = np.full((B, nb, band_mb_rows, mbw), qp, np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb), np.int32)
    slice_qp = np.full((B, nb), qp, np.int32)
    step = make_sharded_intra_step(mesh, W, band_mb_rows)
    sh = NamedSharding(mesh, P("stream", "band"))
    args = [jax.device_put(a, sh) for a in (y, u, v, qp_mb, qpc_mb)]
    args.append(jax.device_put(slice_qp, NamedSharding(mesh,
                                                       P("stream", "band"))))
    return step(*args)


def assemble_band_nals(params, band_words, band_bits, *, band_mb_rows: int,
                       slice_qp: int, frame_num: int = 0, poc: int = 0,
                       idr: bool = True, ptype: bool = False,
                       idr_pic_id: int = 0, deblock_idc: int = 1):
    """Host tail of a sharded frame: merge each band's device payload after
    its own slice header -> list of slice NALs (one per band), mirroring
    x264 sliced threads' per-slice NAL output (encoder.c:3219).

    band_words: [NB, cap_words] uint32; band_bits: [NB] totals.
    deblock_idc=2 codes 'filter inside slice only' (spec 7.4.3), matching
    the band-local device deblock."""
    from ..entropy import nal as nal_mod
    from ..entropy import sets
    from ..entropy.bits import append_bitstring
    from ..entropy.cavlc_jax import words_to_bytes
    from ..entropy.slice_hdr import (SLICE_TYPE_I, SLICE_TYPE_P, SliceHeader,
                                     slice_header_write)
    sps = sets.sps_init(params, params.sps_id)
    pps = sets.pps_init(params, sps, params.sps_id)
    mbw = params.mb_width
    mbs_per_band = band_mb_rows * mbw
    nals = []
    nb = len(band_bits)
    for b in range(nb):
        sh = SliceHeader(sps=sps, pps=pps)
        sh.slice_type = SLICE_TYPE_P if ptype else SLICE_TYPE_I
        sh.first_mb = b * mbs_per_band
        sh.last_mb = sh.first_mb + mbs_per_band - 1
        sh.frame_num = frame_num
        sh.idr = idr
        sh.idr_pic_id = idr_pic_id
        sh.poc_lsb = poc % (1 << sps.log2_max_poc_lsb)
        sh.qp = slice_qp
        if ptype:
            sh.num_ref_idx_l0_active = 1
            sh.num_ref_idx_override = pps.num_ref_idx_l0_active != 1
        sh.disable_deblocking_filter_idc = deblock_idc
        total_bits = int(band_bits[b])
        n_words = (total_bits + 31) // 32
        payload, nbits = words_to_bytes(np.asarray(band_words[b][:n_words]),
                                        total_bits)
        ref_idc = (nal_mod.NAL_PRIORITY_HIGHEST if idr
                   else nal_mod.NAL_PRIORITY_HIGH)
        bw = slice_header_write(sh, ref_idc)
        append_bitstring(bw, payload, nbits)
        bw.rbsp_trailing()
        ntype = nal_mod.NAL_SLICE_IDR if idr else nal_mod.NAL_SLICE
        nals.append(nal_mod.nal_encode(ntype, ref_idc, bw.getvalue()))
    return nals


def make_sharded_pframe_step(mesh: Mesh, width: int, band_mb_rows: int,
                             me_range: int = 8):
    """Jitted multi-device P-frame step: streams over 'stream' (each stream
    encodes its own frame against its own reference — the frame-threads /
    encode-farm analogue), slice bands over 'band' (sliced-threads).

    Band inputs carry a halo-expanded reference (pad rows above/below the
    band) so band-local motion search can reach across band boundaries,
    like x264 sliced threads whose ME may cross slice bounds within the
    same frame (threads share the reference picture)."""
    from ..encoder.inter import encode_pframe_device
    mbw = width // 16
    cap_words = mbw * band_mb_rows * 128

    def band_encode(y, u, v, ry, rhp, rcuv, qp, qpc, slice_qp, lam):
        def one(y1, u1, v1, ry1, rhp1, rcuv1, q1, qc1, sq1, lam1):
            # intra_in_p off in the band step: keeps the sharded graph
            # wavefront-free (slice bands already reset intra pred)
            return encode_pframe_device(
                y1, u1, v1, ry1, rhp1, rcuv1, q1, qc1, sq1, lam1,
                mbw=mbw, mbh=band_mb_rows,
                cap_words=cap_words, me_range=me_range, deblock=True,
                intra_in_p=False)
        return jax.vmap(jax.vmap(one))(y, u, v, ry, rhp, rcuv,
                                       qp, qpc, slice_qp, lam)

    pspec = P("stream", "band")
    step = jax.jit(
        jax.shard_map(
            band_encode, mesh=mesh,
            in_specs=(pspec,) * 10,
            out_specs=pspec,
            check_vma=False,
        ))
    return step


def sharded_pframe_encode(mesh: Mesh, planes_batch, refs_batch, qp: int = 26,
                          band_mb_rows: int = 2, me_range: int = 8):
    """Encode B P-frames (one per stream) against per-stream references,
    each split into NB slice bands over the 'band' axis.

    refs_batch: list of [Y,U,V] recon frames (same shapes as planes)."""
    from ..ops import mc as mc_ops
    from ..ops.tables import chroma_qp
    B = len(planes_batch)
    H, W = planes_batch[0][0].shape
    nb = H // (band_mb_rows * 16)
    mbw = W // 16
    bh = band_mb_rows * 16

    def split(plane, rows):
        return plane.reshape(nb, rows, plane.shape[1])

    ys = np.stack([split(f[0], bh) for f in planes_batch])
    us = np.stack([split(f[1], bh // 2) for f in planes_batch])
    vs = np.stack([split(f[2], bh // 2) for f in planes_batch])

    # per-band padded reference windows (band rows +- PAD, full width +
    # PAD). All prep runs in NUMPY on the host: nothing here may touch the
    # default jax backend — the only device placement is the explicit
    # device_put to the mesh sharding below, so the whole call stays on
    # the mesh's devices whatever the default backend is.
    PAD = mc_ops.PAD
    CPAD = mc_ops.CPAD
    ry_l, rhp_l, rcuv_l = [], [], []
    for f in refs_batch:
        y_pad = np.pad(f[0], PAD, mode="edge")
        hp = mc_ops.hpel_planes_np(y_pad)
        cuv = np.stack([np.pad(f[1], CPAD, mode="edge"),
                        np.pad(f[2], CPAD, mode="edge")])
        ry = np.stack([y_pad[b * bh:b * bh + bh + 2 * PAD]
                       for b in range(nb)])
        rh = np.stack([hp[:, b * bh:b * bh + bh + 2 * PAD]
                       for b in range(nb)])
        rc = np.stack([cuv[:, b * bh // 2:b * bh // 2 + bh // 2 + 2 * CPAD]
                       for b in range(nb)])
        ry_l.append(ry)
        rhp_l.append(rh)
        rcuv_l.append(rc)
    ry = np.stack(ry_l)
    rhp = np.stack(rhp_l)
    rcuv = np.stack(rcuv_l)

    qp_mb = np.full((B, nb, band_mb_rows, mbw), qp, np.int32)
    qpc_mb = np.asarray(chroma_qp(qp_mb), np.int32)
    slice_qp = np.full((B, nb), qp, np.int32)
    lam = np.full((B, nb), max(1, int(round(2.0 ** ((qp - 12) / 6.0)))),
                  np.int32)
    step = make_sharded_pframe_step(mesh, W, band_mb_rows, me_range)
    sh = NamedSharding(mesh, P("stream", "band"))
    args = [jax.device_put(np.asarray(a), sh)
            for a in (ys, us, vs, ry, rhp, rcuv, qp_mb, qpc_mb,
                      slice_qp, lam)]
    return step(*args)
