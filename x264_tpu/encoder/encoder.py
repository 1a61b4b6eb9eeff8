"""Encoder core: lifecycle + per-frame orchestration.

Batched re-design of reference encoder/encoder.c (4603 LoC). The reference
drives a per-MB serial hot loop (slice_write, encoder.c:2752); here each frame
runs as batched device passes (analysis -> wavefront commit -> host entropy),
per SURVEY.md §7.1.

Public API mirrors x264.h:936-1021: Encoder(params), .headers(),
.encode(pic) -> (nals, PicOut), .close(), .reconfig(), .delayed_frames().
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import params as P
from ..entropy import nal as nal_mod
from ..entropy import sets
from ..entropy.bits import BitWriter
from ..entropy.slice_hdr import (SLICE_TYPE_B, SLICE_TYPE_I, SLICE_TYPE_P,
                                 SliceHeader, slice_header_write)

# frame types (reference x264.h:255-263)
TYPE_AUTO, TYPE_IDR, TYPE_I, TYPE_P, TYPE_BREF, TYPE_B, TYPE_KEYFRAME = \
    0, 1, 2, 3, 4, 5, 6


@dataclass
class Picture:
    """Input picture (reference x264_picture_t, x264.h:864-906)."""
    planes: list                   # [Y, U, V] numpy arrays (input size)
    pts: int = 0
    i_type: int = TYPE_AUTO
    qp_offset: float = 0.0
    forced_qp: int = -1
    param: Optional[P.Params] = None
    opaque: object = None          # handed back via param.nalu_process


@dataclass
class PicOut:
    pts: int = 0
    dts: int = 0
    i_type: int = TYPE_IDR
    b_keyframe: bool = False
    qp: int = 0
    recon: Optional[list] = None   # reconstructed planes (display size)
    psnr: Optional[tuple] = None
    ssim: Optional[float] = None


class EncoderError(Exception):
    pass


def frame_redispatch(enc, job):
    """Re-run a pipelined frame's device dispatch against its original
    reference (by DPB tag; the entry was repaired in place after an
    overflow re-encode). The frame_num/poc counters are restored around
    the call since dispatch advances them."""
    from . import frame_encode
    saved = (enc.frame_num, enc.poc)
    enc.frame_num, enc.poc = job["pre_state"]
    try:
        if job["ftype"] == TYPE_B:
            from . import bframe
            return bframe.dispatch_bframe(enc, job["planes"], job["qp"],
                                          job["ref_tag"], job["ref_bwd"])
        return frame_encode.dispatch_frame(enc, job["planes"],
                                           job["ftype"], job["qp"],
                                           ref_tag=job["ref_tag"],
                                           tree_off=job.get("tree_off"),
                                           pir=job.get("pir"))
    finally:
        enc.frame_num, enc.poc = saved


def validate_parameters(p: P.Params) -> P.Params:
    """Clamp/reconcile params (reference validate_parameters encoder.c:423).

    Round-1 subset: grows as features land."""
    p = p.copy()
    if p.width <= 0 or p.height <= 0:
        raise EncoderError(f"invalid size {p.width}x{p.height}")
    if p.width % 2 or (p.height % 2 and p.csp == P.CSP_I420):
        raise EncoderError("width/height must be even for 4:2:0")
    if p.bitdepth not in (8, 10):
        raise EncoderError("bitdepth must be 8 or 10")
    qp_max_spec = P.QP_MAX_SPEC + p.qp_bd_offset
    p.rc.qp_min = max(0, min(p.rc.qp_min, qp_max_spec))
    p.rc.qp_max = max(0, min(p.rc.qp_max, qp_max_spec))
    if p.rc.rc_method == P.RC_CQP:
        if p.rc.qp_constant < 0:
            p.rc.qp_constant = 23 + p.qp_bd_offset
        qp = p.rc.qp_constant
        # per-slice-type CQP (reference validate_parameters: qp_min/max
        # span the I/P/B constants; I frames run ~qp-3 via ip_factor —
        # clamping all types to qp cost 1.8 dB on every I frame)
        import math as _math
        qp_i = int(round(qp - 6.0 * _math.log2(max(p.rc.ip_factor, 0.01))))
        qp_b = int(round(qp + 6.0 * _math.log2(max(p.rc.pb_factor, 0.01))))
        p.rc.qp_min = max(0, min(qp, qp_i, qp_b))
        p.rc.qp_max = min(qp_max_spec, max(qp, qp_i, qp_b))
        p.rc.aq_mode = P.AQ_NONE
        p.rc.mb_tree = False
    p.frame_reference = max(1, min(p.frame_reference, P.REF_MAX))
    # current multi-ref ceiling: 2 L0 references (per-MB selection +
    # te() ref_idx); presets asking for more are clamped so the SPS/PPS
    # signal what the MB layer can actually use
    p.frame_reference = min(p.frame_reference, 2)
    p.bframe = max(0, min(p.bframe, P.BFRAME_MAX))
    if p.keyint_max <= 0:
        p.keyint_max = 1
    if p.keyint_min < 0:
        p.keyint_min = min(p.keyint_max // 10, 25) if p.keyint_max > 1 else 1
    p.keyint_min = max(1, min(p.keyint_min, p.keyint_max // 2 + 1))
    if p.keyint_max == 1:
        p.scenecut_threshold = 0
        p.intra_refresh = False
    if p.intra_refresh:
        # PIR constraints (reference encoder.c:1087-1098): single ref;
        # B frames additionally unsupported here until the sweep handles
        # bi-directional reference geometry
        p.frame_reference = 1
        p.bframe = 0
    p.rc.lookahead = max(0, min(p.rc.lookahead, P.LOOKAHEAD_MAX))
    p.rc.lookahead = min(p.rc.lookahead, p.keyint_max)
    # MB-tree drives per-MB offsets from the lookahead; until the ABR/VBV
    # bit predictors are taught the offset-induced complexity shift
    # (reference rate_estimate_qscale folds it in), keep it to CRF where
    # the rate target is implicit
    if p.rc.rc_method != P.RC_CRF:
        p.rc.mb_tree = False
    if p.bframe == 0:
        p.bframe_pyramid = P.B_PYRAMID_NONE
        p.bframe_adaptive = P.B_ADAPT_NONE
    # round-1 feature gates
    if p.analyse.weighted_pred > 1:
        p.analyse.weighted_pred = 1   # SMART's dup-ref trick not needed:
        # weights apply directly on the single signaled ref
    # 8x8 transform unimplemented: must stay off until the mb-layer writes
    # transform_size_8x8_flag for inter MBs (spec 7.3.5)
    p.analyse.transform_8x8 = False
    if p.interlaced:
        raise EncoderError("interlaced encoding not yet implemented")
    if p.bitdepth != 8:
        raise EncoderError("10-bit not yet wired end-to-end")
    return p


class Encoder:
    """Top-level encoder (reference x264_t + x264_encoder_* API)."""

    def __init__(self, params: P.Params) -> None:
        self.p = validate_parameters(params)
        from ..utils.log import Logger
        self.log = Logger(self.p.log_level)   # pf_log analogue
        self.sps = sets.sps_init(self.p, self.p.sps_id)
        self.pps = sets.pps_init(self.p, self.sps, self.p.sps_id)
        self.mb_w, self.mb_h = self.p.mb_width, self.p.mb_height
        self.frame_num = 0          # frame_num syntax element
        self.idr_pic_id = 0
        self.frames_in = 0          # pictures accepted
        self.frames_out = 0
        self.last_keyframe = -(1 << 30)
        # decision-time keyframe tracker: decide() runs ahead of
        # dispatch (ready-queue flow control), so keyint cadence must
        # advance when an IDR is DECIDED, not when it is dispatched
        self._kf_decided = -(1 << 30)
        self.poc = 0
        from .lookahead import Lookahead
        from .ratecontrol import RateControl
        self.rc = RateControl(self.p)
        self._lookahead = Lookahead(self.p)
        self._dpb: list = []        # reference frames (device arrays)
        # signaled DPB refs: both B anchors stay referenced (sliding
        # window evicts older anchors automatically); multi-ref P keeps
        # frame_reference entries live
        self.n_refs = min(self.p.frame_reference, 2)
        self._max_refs = max(self.n_refs, 2 if self.p.bframe > 0 else 1)
        self._pipe: list = []       # in-flight frame jobs (frame-threads)
        self._pipe_depth = 1 if self.p.threads != 1 else 0
        self._ready: list = []      # decided, not yet dispatched (RC
        # feedback pacing: dispatch happens as the pipe drains, so a
        # deep lookahead window cannot burst 16 rc.start calls before
        # the first rc.update — reference encoder.c paces identically
        # through the frame-thread handoff)
        # periodic-intra-refresh sweep state (reference encoder.c:3626:
        # f_pir_position / i_frames_since_pir / b_queued_intra_refresh);
        # pos == mb_w means "no active sweep", prev_end is the most
        # recent reference's refreshed end column (its MV-cap boundary)
        self._pir_state = {"pos": float(self.mb_w), "since": 0,
                           "prev_end": 0}
        self._queued_refresh = False
        self._idr_display_base = 0
        self._coding_out = 0        # frames dispatched (coding order)
        self._closed = False
        # stats accumulation (reference encoder_close stats, encoder.c:4196)
        self.stats = {"frames": 0, "bytes": 0,
                      "count": {"I": 0, "P": 0, "B": 0},
                      "qp_sum": {"I": 0.0, "P": 0.0, "B": 0.0},
                      "bytes_by_type": {"I": 0, "P": 0, "B": 0},
                      "ssd": np.zeros(3, dtype=np.float64),
                      "psnr_frames": 0}

    # ------------------------------------------------------------- headers
    def headers(self) -> list[nal_mod.NAL]:
        """SPS+PPS (+SEI suite) NALs (reference x264_encoder_headers +
        the SEI writes in encoder_encode, encoder.c:3662-3853)."""
        def sei(payload):
            return nal_mod.nal_encode(nal_mod.NAL_SEI,
                                      nal_mod.NAL_PRIORITY_DISPOSABLE,
                                      payload)
        nals = [
            nal_mod.nal_encode(nal_mod.NAL_SPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.sps_write(self.sps)),
            nal_mod.nal_encode(nal_mod.NAL_PPS, nal_mod.NAL_PRIORITY_HIGHEST,
                               sets.pps_write(self.pps)),
            sei(sets.sei_version(self.p)),
        ]
        if self.p.frame_packing >= 0:
            nals.append(sei(sets.sei_frame_packing(self.p.frame_packing)))
        if self.p.mastering_display:
            import re
            v = [int(x) for x in re.findall(r"-?\d+",
                                            self.p.mastering_display)]
            if len(v) == 10:
                nals.append(sei(sets.sei_mastering_display(
                    [(v[0], v[1]), (v[2], v[3]), (v[4], v[5])],
                    (v[6], v[7]), v[8], v[9])))
        if self.p.content_light_level:
            try:
                cll, fall = (int(x) for x in
                             self.p.content_light_level.split(","))
                nals.append(sei(sets.sei_content_light_level(cll, fall)))
            except ValueError:
                pass
        if self.p.alternative_transfer != 2:
            nals.append(sei(sets.sei_alternative_transfer(
                self.p.alternative_transfer)))
        return nals

    def delayed_frames(self) -> int:
        return (len(self._pipe) + len(self._ready)
                + len(self._lookahead))

    # ------------------------------------------------------------- encode
    def encode(self, pic: Optional[Picture]) -> tuple[list, Optional[PicOut]]:
        """Encode one picture; returns (nals, pic_out).

        Frames enter the lookahead window; once the window is deep
        enough the slicetype decision emits whole minigops in coding
        order (reference x264_slicetype_decide, slicetype.c:1745).
        With threads>1 (or auto) the encoder additionally runs a host
        pipeline one frame deep — the frame-threads analogue
        (encoder.c:3337). Total delay = lookahead depth + pipe depth;
        drain with encode(None)."""
        if self._closed:
            raise EncoderError("encoder closed")
        flush = pic is None
        if pic is not None:
            planes = self._pad_to_mb(pic.planes)
            self._lookahead.push(planes, pic, self.frames_in)
            self.frames_in += 1
        while True:
            decided = self._lookahead.decide(self._kf_decided, flush)
            if not decided:
                break
            for entry, ftype, _rf, _rb in decided:
                if ftype == TYPE_IDR:
                    self._kf_decided = entry["idx"]
            self._ready += decided
        self._dispatch_ready()
        if flush:
            if self._pipe:
                out = self._finalize_job(self._pipe.pop(0))
                self._dispatch_ready()
                return out
            return [], None
        if len(self._pipe) <= self._pipe_depth:
            return [], None
        out = self._finalize_job(self._pipe.pop(0))
        self._dispatch_ready()
        return out

    def _dispatch_ready(self) -> None:
        """Move decided frames into the device pipe while it has room
        (at most pipe_depth+1 in flight), keeping rc.start within one
        pipe-depth of the bits feedback from rc.update."""
        while self._ready and len(self._pipe) <= self._pipe_depth:
            entry, ftype, ref_fwd, ref_bwd = self._ready.pop(0)
            if ftype == TYPE_B:
                self._enqueue_frame(entry["planes"], TYPE_B,
                                    entry["pic"], entry["idx"],
                                    ref_fwd=ref_fwd, ref_bwd=ref_bwd)
            else:
                self._enqueue_frame(entry["planes"], ftype,
                                    entry["pic"], entry["idx"],
                                    tree_off=entry.get("tree_off"))

    def _pir_advance(self, ftype, idx):
        """Advance the periodic-intra-refresh sweep for one frame
        (reference encoder.c:3626-3660): keyframes become P frames that
        restart the refresh column sweep; returns (ftype, pir_geom,
        is_recovery_point). pir_geom = (start_col, end_col, ref_end) for
        dispatch_pframe, or None when PIR contributes nothing."""
        st = self._pir_state
        mbw = self.mb_w
        force = False
        if ftype in (TYPE_IDR, TYPE_I):
            if not self._dpb:
                # nothing decodable to sweep over: a real IDR, which
                # refreshes everything (reference encoder.c:3628-3634)
                st.update(pos=float(mbw), since=0, prev_end=0)
                return ftype, None, False
            ftype = TYPE_P
            force = True
        keyint = max(self.p.keyint_max, 1)
        inc = max((mbw - 1) / keyint, 1.0)
        pos = st["pos"]
        since = st["since"] + 1
        recovery = False
        if force or since >= keyint or (self._queued_refresh
                                        and pos + 0.5 >= mbw):
            pos, since = 0.0, 0
            self._queued_refresh = False
            recovery = True
            self.last_keyframe = idx
        start_col = int(pos + 0.5)
        pos += inc
        end_col = int(pos + 0.5)
        if end_col >= mbw - 1:
            pos = float(mbw)
            end_col = mbw - 1
        ref_end = st["prev_end"]
        st.update(pos=pos, since=since, prev_end=end_col)
        return ftype, (start_col, end_col,
                       ref_end if ref_end > 0 else None), recovery

    def _enqueue_frame(self, planes, ftype, pic, idx, ref_fwd=None,
                       ref_bwd=None, tree_off=None) -> None:
        """Dispatch one frame in coding order and append its job
        (reference slices_write dispatch, encoder.c:3885)."""
        pir_geom = None
        recovery = False
        if self.p.intra_refresh:
            ftype, pir_geom, recovery = self._pir_advance(ftype, idx)
        is_idr = ftype == TYPE_IDR
        if is_idr:
            self.last_keyframe = idx
            self.frame_num = 0
            self._idr_display_base = idx
            self._dpb.clear()
            self._last_ref_fn = None    # decoder DPB resets at IDR
        self.poc = 2 * (idx - self._idr_display_base)

        qp = self._decide_qp(ftype, pic, idx)
        pre_state = (self.frame_num, self.poc)
        if ftype == TYPE_B:
            from . import bframe
            finalize, retry, recon_dev, _ = bframe.dispatch_bframe(
                self, planes, qp, ref_fwd, ref_bwd)
        else:
            finalize, retry, recon_dev, ref_fwd = self._dispatch_frame(
                planes, ftype, qp, pic, tree_off, pir=pir_geom)
            # this frame is now the decoder's most recent reference — the
            # default list0[0] the NEXT frame's ref choice is compared
            # against (apply_ref_list_mod, encoder.c:3485-3583 analogue)
            self._last_ref_fn = self.frame_num
            # reference pictures advance frame_num (spec 7.4.3)
            self.frame_num = (self.frame_num + 1) % (
                1 << self.sps.log2_max_frame_num)
        tag = idx
        if recon_dev is not None:
            # keep the SOURCE luma of reference frames on the host: the
            # next frame's weightp fit reads it (slicetype.c:284 uses
            # fenc planes; recon would sync the device pipe)
            if not hasattr(self, "_src_luma"):
                self._src_luma = {}
            self._src_luma[tag] = np.asarray(planes[0])
            self._dpb_push(recon_dev, tag)
            live = {r["tag"] for r in self._dpb}
            for k in [k for k in self._src_luma if k not in live]:
                del self._src_luma[k]
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 65536

        b_active = self.p.bframe > 0
        dts = self._coding_out - (1 if b_active else 0)
        self._coding_out += 1
        job = {"finalize": finalize, "retry": retry, "pts": pic.pts,
               "dts": dts, "ftype": ftype, "is_idr": is_idr, "qp": qp,
               "planes": planes, "tag": tag, "pre_state": pre_state,
               "ref_tag": ref_fwd, "ref_bwd": ref_bwd,
               "tree_off": tree_off, "pir": pir_geom,
               "recovery": recovery, "opaque": pic.opaque}
        self._pipe.append(job)

    def _finalize_job(self, job) -> tuple[list, PicOut]:
        from .intra import PayloadOverflow
        finalize = job["finalize"]
        pts, ftype, is_idr, qp, planes = (job["pts"], job["ftype"],
                                          job["is_idr"], job["qp"],
                                          job["planes"])
        try:
            nals, recon = finalize()
        except PayloadOverflow:
            nals, recon, qp = self._overflow_reencode(job)
        if job.get("recovery"):
            # sweep-restart frame: a recovery point the stream can be
            # joined at (reference encoder.c:3744: time_to_recovery =
            # min(mb_w-1, keyint) + bframe - 1)
            ttr = min(self.mb_w - 1, self.p.keyint_max) - 1
            nals = [nal_mod.nal_encode(
                nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                sets.sei_recovery_point(max(ttr, 0)))] + nals
        if self.sps.nal_hrd_parameters:
            # HRD SEIs (reference encoder.c:3723-3767): buffering period
            # at every IDR, picture timing on every AU; delays in ticks
            # of 2 fields per frame
            hrd = []
            if is_idr:
                # real CPB fullness (reference x264_hrd_fullness) from
                # the VBV state, in 90 kHz ticks of the SIGNALED rate
                init_delay, init_offset = self.rc.hrd_fullness(
                    self.sps.hrd_bitrate_unscaled,
                    self.sps.hrd_cpb_size_unscaled)
                hrd.append(nal_mod.nal_encode(
                    nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                    sets.sei_buffering_period(self.sps, init_delay,
                                              init_offset)))
                self._hrd_bp_idx = self.frames_out
            cpb_delay = 2 * (self.frames_out
                             - getattr(self, "_hrd_bp_idx", 0))
            dpb_delay = 2 * max(0, pts - job.get("dts", pts))
            hrd.append(nal_mod.nal_encode(
                nal_mod.NAL_SEI, nal_mod.NAL_PRIORITY_DISPOSABLE,
                sets.sei_pic_timing(self.sps, cpb_delay, dpb_delay)))
            nals = hrd + nals
        if self.sps.nal_hrd_parameters and self.sps.hrd_cbr:
            # CBR: convert decoder-buffer overflow into filler NALs so
            # the stream really is constant-rate (reference hrd_filler,
            # NAL_FILLER after the slice in the same AU)
            fill_bits = self.rc.hrd_filler_bits()
            if fill_bits:
                k = max(0, fill_bits // 8 - 6)   # startcode+hdr+stop
                nals = nals + [nal_mod.nal_encode(
                    nal_mod.NAL_FILLER, nal_mod.NAL_PRIORITY_DISPOSABLE,
                    b"\xff" * k + b"\x80")]
        if self.p.aud:
            from .intra import aud_nal
            nals = [aud_nal(ftype)] + nals
        if self.p.nalu_process is not None:
            # low-latency per-NAL callback (reference x264.h:584-618
            # nalu_process): the app can ship each NAL before encode()
            # returns the whole AU
            for nal in nals:
                self.p.nalu_process(self, nal, job.get("opaque"))
        out = PicOut(pts=pts, dts=job.get("dts", pts), i_type=ftype,
                     b_keyframe=is_idr or bool(job.get("recovery")), qp=qp,
                     recon=[r[:self.p.height, :self.p.width] if i == 0 else
                            r[:self._chroma_h(), :self._chroma_w()]
                            for i, r in enumerate(recon)] if recon else None)
        self.frames_out += 1
        tkey = {TYPE_IDR: "I", TYPE_I: "I", TYPE_P: "P",
                TYPE_B: "B", TYPE_BREF: "B"}[ftype]
        self.stats["frames"] += 1
        self.stats["count"][tkey] += 1
        self.stats["qp_sum"][tkey] += qp
        nbytes = sum(len(n.payload) + 4 for n in nals)
        self.stats["bytes"] += nbytes
        self.stats["bytes_by_type"][tkey] += nbytes
        if self.p.analyse.psnr and recon is not None:
            for i, (a, b) in enumerate(zip(self._crop(planes), out.recon)):
                d = a.astype(np.float64) - b.astype(np.float64)
                self.stats["ssd"][i] += float((d * d).sum())
            self.stats["psnr_frames"] += 1
            out.psnr = self._frame_psnr(self._crop(planes), out.recon)
        if self.p.analyse.ssim and recon is not None:
            from ..ops.pixel import ssim as ssim_op
            out.ssim = float(ssim_op(np.asarray(self._crop(planes)[0]),
                                     np.asarray(out.recon[0])))
            self.stats["ssim_sum"] = self.stats.get("ssim_sum", 0.0) \
                + out.ssim
            self.stats["ssim_frames"] = self.stats.get("ssim_frames", 0) + 1
        return nals, out

    # ------------------------------------------------------------ helpers
    def _chroma_w(self) -> int:
        return self.p.width // (2 if self.p.chroma_format_idc == 1 else
                                2 if self.p.chroma_format_idc == 2 else 1)

    def _chroma_h(self) -> int:
        return self.p.height // (2 if self.p.chroma_format_idc == 1 else 1)

    def _crop(self, planes):
        return [planes[0][:self.p.height, :self.p.width],
                planes[1][:self._chroma_h(), :self._chroma_w()],
                planes[2][:self._chroma_h(), :self._chroma_w()]]

    def _frame_psnr(self, src, rec):
        peak = (1 << self.p.bitdepth) - 1
        vals = []
        for a, b in zip(src, rec):
            d = a.astype(np.float64) - b.astype(np.float64)
            mse = (d * d).mean()
            vals.append(10 * np.log10(peak * peak / max(mse, 1e-12)))
        return tuple(vals)

    def _pad_to_mb(self, planes: list) -> list:
        """Pad planes to MB-aligned sizes by edge replication
        (reference expand_border_mod16, frame.c:640)."""
        out = []
        for i, pl in enumerate(planes):
            if i == 0:
                th, tw = self.mb_h * 16, self.mb_w * 16
            else:
                cdiv_w = 2 if self.p.chroma_format_idc in (1, 2) else 1
                cdiv_h = 2 if self.p.chroma_format_idc == 1 else 1
                th, tw = self.mb_h * 16 // cdiv_h, self.mb_w * 16 // cdiv_w
            ph, pw = th - pl.shape[0], tw - pl.shape[1]
            if ph or pw:
                pl = np.pad(pl, ((0, ph), (0, pw)), mode="edge")
            out.append(pl)
        return out

    def _decide_qp(self, ftype: int, pic: Picture, idx: int = None) -> int:
        if self.rc.vbv:
            # feed the VBV lookahead walk the planned costs of every
            # frame still ahead of this one: decided-but-undispatched
            # frames in the ready queue (stamped at decide time), then
            # the undecided lookahead window (reference vbv_lookahead,
            # slicetype.c:1225; r4 verdict item 6 — set_lookahead_costs
            # must run on product encodes)
            ahead = [e.get("plan_cost", 0.0) for e, *_ in self._ready]
            self.rc.set_lookahead_costs(
                ahead + self._lookahead.planned_costs())
        return self.rc.start(ftype, pic.forced_qp, frame_idx=idx)

    # -------------------------------------------------------- frame encode
    def _dispatch_frame(self, planes, ftype, qp, pic, tree_off=None,
                        pir=None):
        """Returns (finalize_fn, retry_fn, recon_dev, ref_tag)."""
        from . import frame_encode
        return frame_encode.dispatch_frame(self, planes, ftype, qp,
                                           tree_off=tree_off, pir=pir)

    def _overflow_reencode(self, job):
        """Device CAVLC buffer overflow: re-encode the frame at higher QP
        (reference encoder.c:2893-2902), then repair the DPB entry and
        re-dispatch any in-flight frames that referenced the stale recon."""
        from .intra import PayloadOverflow
        qp_try = job["qp"]
        while True:
            qp_try = min(qp_try + 4, P.QP_MAX_SPEC)
            finalize2, recon_dev2 = job["retry"](qp_try)
            try:
                nals, recon = finalize2()
                break
            except PayloadOverflow:
                if qp_try >= P.QP_MAX_SPEC:
                    raise
        if recon_dev2 is not None:          # B frames store no recon
            self._dpb_replace(job["tag"], recon_dev2)
        # frames dispatched against the stale recon must be re-dispatched
        for j2 in self._pipe:
            fin, retry, recon_dev, _ = frame_redispatch(self, j2)
            j2["finalize"], j2["retry"] = fin, retry
            if recon_dev is not None:
                self._dpb_replace(j2["tag"], recon_dev)
        return nals, recon, qp_try

    def _dpb_replace(self, tag, recon) -> None:
        for i, ref in enumerate(self._dpb):
            if ref.get("tag") == tag:
                fnum, poc = ref["frame_num"], ref["poc"]
                self._dpb_push_entry(recon, tag, fnum, poc, i)
                return
        raise AssertionError(f"DPB repair: tag {tag} already evicted "
                             "(retention must cover pipe depth)")

    def _dpb_push_entry(self, recon, tag, frame_num, poc, at=None):
        import jax.numpy as jnp

        from ..ops import mc as mc_ops
        y_pad = mc_ops.pad_plane(jnp.asarray(recon[0]))
        ref = {
            "y_pad": y_pad,
            "hpel": mc_ops.hpel_planes(y_pad),
            "cuv_pad": jnp.stack(
                [mc_ops.pad_plane(jnp.asarray(recon[1]), mc_ops.CPAD),
                 mc_ops.pad_plane(jnp.asarray(recon[2]), mc_ops.CPAD)]),
            "frame_num": frame_num,
            "poc": poc,
            "tag": tag,
        }
        # colocated MV/ref fields for B spatial direct (set by the
        # dispatch that produced this reconstruction)
        ref.update(getattr(self, "_pending_ref_fields", None) or {})
        self._pending_ref_fields = None
        if at is None:
            self._dpb.append(ref)
        else:
            self._dpb[at] = ref

    def _dpb_push(self, recon, tag=-1) -> None:
        """Insert a reconstructed frame into the (device-resident) DPB:
        border-extend + build half-pel planes once per reference
        (reference x264_frame_filter / frame.c border expansion).

        Retention exceeds the signaled ref count by the pipeline depth so
        an in-flight frame's reference can still be repaired in place
        after an overflow re-encode (the extra entries are never signaled
        in the stream — see _slice_header)."""
        self._dpb_push_entry(recon, tag, self.frame_num, self.poc)
        keep = self._max_refs + self._pipe_depth
        while len(self._dpb) > keep:
            self._dpb.pop(0)

    def _slice_header(self, ftype: int, qp: int, first_mb: int = 0,
                      last_mb: int = -1, n_ref_l0: int = 1) -> SliceHeader:
        sh = SliceHeader(sps=self.sps, pps=self.pps)
        sh.slice_type = (SLICE_TYPE_I if ftype in (TYPE_IDR, TYPE_I) else
                         SLICE_TYPE_P if ftype == TYPE_P else SLICE_TYPE_B)
        sh.first_mb = first_mb
        sh.last_mb = last_mb if last_mb >= 0 else self.mb_w * self.mb_h - 1
        sh.frame_num = self.frame_num
        sh.idr = ftype == TYPE_IDR
        sh.idr_pic_id = self.idr_pic_id
        sh.poc_lsb = self.poc % (1 << self.sps.log2_max_poc_lsb)
        sh.qp = qp
        # per-slice active count: P slices use up to n_refs once the DPB
        # holds that many (the first P after an IDR has one); B lists
        # stay 1 deep
        sh.num_ref_idx_l0_active = n_ref_l0
        sh.num_ref_idx_l1_active = 1
        sh.num_ref_idx_override = (
            sh.slice_type in (SLICE_TYPE_P, SLICE_TYPE_B)
            and (self.pps.num_ref_idx_l0_active != sh.num_ref_idx_l0_active
                 or (sh.slice_type == SLICE_TYPE_B
                     and self.pps.num_ref_idx_l1_active
                     != sh.num_ref_idx_l1_active)))
        if not self.p.deblocking_filter:
            sh.disable_deblocking_filter_idc = 1
        sh.alpha_c0_offset = self.p.deblocking_filter_alphac0 * 2
        sh.beta_offset = self.p.deblocking_filter_beta * 2
        return sh

    def precompile(self) -> float:
        """Warm the per-frame STAGE programs concurrently.

        The I and P pipelines run as staged jits (encode_iframe_staged /
        encode_pframe_staged) — ~10 independent programs instead of two
        fused ones, sidestepping XLA's superlinear whole-program
        optimization cost. First-use compilation would still serialize
        (stage k+1 cannot dispatch before stage k ran), so warmup runs
        in two passes (encoder/stagewarm.py): PLAN — dispatch gray
        frames on throwaway encoder clones with every stage call
        recorded and answered by shape-correct zeros (jax.eval_shape, no
        compilation); WARM — replay all recorded calls from threads, so
        the XLA compiler service overlaps them and warmup wall-time is
        max(stage compile) instead of sum (r4 verdict item 4). The
        compiled programs land in the in-process jit cache keyed by
        (function, shapes, static flags), which this encoder shares.
        Returns the wall seconds spent."""
        import time as _time
        from . import frame_encode
        from .stagewarm import StagePlan, warm_calls
        t0 = _time.time()
        gray = [np.full((self.mb_h * 16, self.mb_w * 16), 128, np.uint8),
                np.full((self.mb_h * 8, self.mb_w * 8), 128, np.uint8),
                np.full((self.mb_h * 8, self.mb_w * 8), 128, np.uint8)]
        qp = self.rc.start(TYPE_P, -1, frame_idx=0)
        qp_i = self.rc.start(TYPE_IDR, -1, frame_idx=0)
        plan = StagePlan()
        with plan:
            enc = Encoder(self.p)
            frame_encode.dispatch_frame(enc, gray, TYPE_IDR, qp_i)
            if self.p.keyint_max > 1:
                enc2 = Encoder(self.p)
                enc2._last_ref_fn = None
                enc2._pending_ref_fields = None
                enc2._dpb_push(gray, tag=0)
                enc2._pending_ref_fields = None
                enc2._dpb_push(gray, tag=1)
                frame_encode.dispatch_frame(enc2, gray, TYPE_P, qp)
        warm_calls(plan.calls)
        return _time.time() - t0

    # --------------------------------------------------------------- misc
    def reconfig(self, new_params: P.Params) -> None:
        """Runtime re-config of the mutable subset (encoder.c:1862)."""
        mutable = ["rc", "analyse", "deblocking_filter",
                   "deblocking_filter_alphac0", "deblocking_filter_beta",
                   "keyint_max", "scenecut_threshold"]
        for name in mutable:
            setattr(self.p, name, getattr(new_params, name))

    def intra_refresh(self) -> None:
        """Queue an intra refresh (reference x264_encoder_intra_refresh,
        encoder.c:3280): with --intra-refresh on, the next P frame after
        the current sweep completes restarts the column sweep; without
        PIR, the next frame is coded IDR."""
        if self.p.intra_refresh:
            self._queued_refresh = True
        else:
            self.last_keyframe = -(1 << 30)
            self._kf_decided = -(1 << 30)

    def invalidate_reference(self, pts: int) -> int:
        """Mark reconstructed frames with pts >= `pts` unusable
        (reference x264_encoder_invalidate_reference, encoder.c:3286):
        the decoder lost them, so later frames must not predict from
        them. Entries older than `pts` stay usable; if none remain, the
        next frame is forced IDR (reference encoder.c:3485-3497)."""
        keep = [r for r in self._dpb if r["tag"] < pts]
        dropped = len(self._dpb) - len(keep)
        self._dpb = keep
        if dropped and self.sps.num_ref_frames < 2:
            # survivor would be outside the decoder's 1-frame sliding
            # window: the only conformant recovery is an IDR
            self._dpb = []
        if not self._dpb:
            # nothing valid left: force a recovery IDR
            # (reference encoder.c:3485-3497)
            self.last_keyframe = -(1 << 30)
            self._kf_decided = -(1 << 30)
        # else: the next P re-references the newest SURVIVING entry; it is
        # older than the decoder's default list0[0] (the corrupt frame is
        # still in the decoder DPB), so dispatch_pframe emits
        # ref_pic_list_modification_l0 (apply_ref_list_mod). The survivor
        # stays inside the decoder's sliding window because
        # sps.num_ref_frames >= 2 covers the retained pipe entries.
        return 0 if dropped or not self._dpb else -1

    def close(self) -> dict:
        self._closed = True
        self.rc.write_stats()    # pass-1 stat file (ratecontrol.c:1829)
        return self.stats
