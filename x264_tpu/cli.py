"""x264-compatible command line (reference: x264.c, 2105 LoC).

Usage: python -m x264_tpu.cli [options] -o out.264 in.y4m
Options use the same names as the reference CLI; unknown long options fall
through to the param string parser (x264_param_parse equivalence), so most
x264 command lines work unchanged.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import params as P
from .encoder.encoder import Encoder, Picture
from .io.output import open_output
from .io.y4m import RawReader, Y4MReader, Y4MWriter, VideoInfo


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="x264-tpu", add_help=True,
        description="H.264 encoder in JAX (x264-compatible CLI)")
    ap.add_argument("input", help="input file (.y4m or raw .yuv)")
    ap.add_argument("-o", "--output", required=True, help="output .264")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--tune", default=None)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--frames", type=int, default=0,
                    help="max frames to encode")
    ap.add_argument("--seek", type=int, default=0, help="first frame")
    ap.add_argument("--input-res", default=None,
                    help="WxH for raw input")
    ap.add_argument("--fps", default=None)
    ap.add_argument("--dump-yuv", default=None,
                    help="dump reconstruction to file")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    return ap


# CLI-level options (everything else falls through to param_parse)
_CLI_VALUE_OPTS = {"-o", "--output", "--preset", "--tune", "--profile",
                   "--frames", "--seek", "--input-res", "--fps",
                   "--dump-yuv", "--muxer", "--demuxer", "--qpfile", "--vf",
                   "--video-filter", "--tcfile-in", "--tcfile-out",
                   "--timebase", "--log-level"}
_CLI_FLAG_OPTS = {"--quiet", "--verbose", "-h", "--help"}
# boolean encoder options that never take a value
_NO_VALUE_PARAMS = {"no-cabac", "no-deblock", "no-scenecut", "cabac",
                    "intra-refresh", "aud", "psnr", "ssim", "no-psnr",
                    "no-ssim", "no-mbtree", "mbtree", "no-8x8dct", "8x8dct",
                    "no-mixed-refs", "mixed-refs", "no-fast-pskip",
                    "fast-pskip", "no-dct-decimate", "dct-decimate",
                    "no-weightb", "weightb", "open-gop", "stitchable",
                    "fake-interlaced", "bluray-compat", "sliced-threads",
                    "no-sliced-threads", "no-psy", "psy", "no-chroma-me",
                    "chroma-me", "constrained-intra", "no-deterministic",
                    "thread-input", "no-thread-input",
                    "slow-firstpass", "nf", "filler", "pic-struct",
                    "force-cfr", "no-progress"}


def main(argv=None) -> int:
    from .utils.jaxcache import enable_compile_cache
    enable_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    cli = {"preset": "medium", "tune": None, "profile": None, "frames": 0,
           "seek": 0, "input_res": None, "fps": None, "dump_yuv": None,
           "quiet": False, "verbose": False, "output": None, "input": None,
           "muxer": None, "demuxer": None, "qpfile": None, "vf": None,
           "video_filter": None,
           "tcfile_in": None, "tcfile_out": None, "timebase": None,
           "log_level": None}
    passthrough = []           # (name, value)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-h", "--help", "--longhelp", "--fullhelp"):
            # 3 help levels like the reference (x264.c help/longhelp/
            # fullhelp): base CLI, +frequently used encoder keys, +every
            # parser key
            build_argparser().print_help()
            level = ("-h", "--help", "--longhelp",
                     "--fullhelp").index(tok)
            if level >= 2:
                print("\nFrequently used encoder options "
                      "(--key value or --key=value):")
                for k in ("qp", "crf", "bitrate", "preset", "tune",
                          "profile", "keyint", "min-keyint", "scenecut",
                          "bframes", "ref", "no-cabac", "no-deblock",
                          "deblock", "aq-mode", "aq-strength", "merange",
                          "threads", "vbv-maxrate", "vbv-bufsize", "pass",
                          "stats", "qpfile", "vf", "muxer"):
                    print(f"  --{k}")
            if level >= 3:
                from . import params as _P
                import inspect
                src = inspect.getsource(_P.param_parse)
                keys = sorted(set(
                    s.strip('"') for s in
                    __import__("re").findall(r'"[a-z0-9-]+"', src)))
                print("\nAll parser keys (x264_param_parse parity):")
                for k in keys:
                    print(f"  --{k}")
            return 0
        if tok in _CLI_FLAG_OPTS:
            cli[tok.lstrip("-")] = True
        elif tok in _CLI_VALUE_OPTS:
            if i + 1 >= len(argv):
                print(f"missing value for {tok}", file=sys.stderr)
                return 2
            key = "output" if tok == "-o" else tok[2:].replace("-", "_")
            cli[key] = argv[i + 1]
            i += 1
        elif tok == "--no-progress":
            cli["no_progress"] = True
        elif tok.startswith("--"):
            name = tok[2:]
            value = None
            if "=" in name:
                name, value = name.split("=", 1)
            elif (name not in _NO_VALUE_PARAMS and i + 1 < len(argv)
                  and not argv[i + 1].startswith("--")):
                value = argv[i + 1]
                i += 1
            passthrough.append((name, value))
        else:
            cli["input"] = tok
        i += 1
    if not cli["input"] or not cli["output"]:
        print("usage: x264-tpu [options] -o out.264 in.y4m",
              file=sys.stderr)
        return 2

    class _NS:                       # argparse-compatible view
        pass
    known = _NS()
    for k, v in cli.items():
        setattr(known, k, v)
    known.frames = int(cli["frames"])
    known.seek = int(cli["seek"])

    # CLI-only flags that are not encoder params (reference x264.c options)
    thread_input = True
    kept = []
    for name, value in passthrough:
        if name in ("thread-input", "no-thread-input"):
            thread_input = name == "thread-input"
        else:
            kept.append((name, value))
    passthrough = kept

    p = P.param_default_preset(known.preset, known.tune)
    for name, value in passthrough:
        try:
            P.param_parse(p, name, value)
        except P.ParamError as e:
            print(f"x264-tpu [error]: {e}", file=sys.stderr)
            return 2

    # --- input (reference select_input, x264.c:1228: probe by extension /
    # --demuxer, lavf as the anything-else fallback) ---
    demuxer = (cli.get("demuxer") or "auto").lower()
    is_raw = known.input.endswith((".yuv", ".raw")) or known.input_res
    if demuxer == "lavf" or (
            demuxer == "auto" and not known.input.endswith(".y4m")
            and not is_raw):
        from .io.lavf import LavfReader
        try:
            reader = LavfReader(known.input)
        except Exception as e:
            print(f"x264-tpu [error]: lavf: {e}", file=sys.stderr)
            return 2
    elif demuxer == "y4m" or known.input.endswith(".y4m"):
        reader = Y4MReader(known.input)
    else:
        if not known.input_res:
            print("raw input requires --input-res WxH", file=sys.stderr)
            return 2
        w, h = map(int, known.input_res.lower().split("x"))
        fps = (25, 1)
        if known.fps:
            fps = tuple(map(int, known.fps.split("/"))) \
                if "/" in known.fps else (int(float(known.fps) * 1000), 1000)
        reader = RawReader(known.input, w, h, fps=fps)
    # --- filter chain (reference init_vid_filters, x264.c:1305) ---
    from .io.filters import build_chain
    try:
        reader = build_chain(reader, cli.get("vf") or cli.get(
            "video_filter"))
    except ValueError as e:
        print(f"x264-tpu [error]: {e}", file=sys.stderr)
        return 2
    # async read-ahead (reference input/thread.c; --no-thread-input off)
    if thread_input:
        from .io.thread_input import ThreadedReader
        reader = ThreadedReader(reader)
    info = reader.info
    p.width, p.height = info.width, info.height
    p.fps_num, p.fps_den = info.fps_num, info.fps_den
    if info.sar_width:
        p.vui.sar_width, p.vui.sar_height = info.sar_width, info.sar_height

    if known.profile:
        P.param_apply_profile(p, known.profile)
    if known.dump_yuv:
        p.dump_yuv = known.dump_yuv

    # --- logging level (reference --log-level/--quiet/--verbose) ---
    from .utils import log as logmod
    if cli.get("log_level") is not None:
        names = {"none": logmod.LOG_NONE, "error": logmod.LOG_ERROR,
                 "warning": logmod.LOG_WARNING, "info": logmod.LOG_INFO,
                 "debug": logmod.LOG_DEBUG}
        lv = cli["log_level"]
        p.log_level = names.get(str(lv).lower(),
                                int(lv) if str(lv).lstrip("-").isdigit()
                                else logmod.LOG_INFO)
    elif cli["quiet"]:
        p.log_level = logmod.LOG_NONE
    elif cli["verbose"]:
        p.log_level = logmod.LOG_DEBUG
    logmod.set_level(p.log_level)

    # --- VFR: --tcfile-in / --timebase (reference x264.c:1675-1736,
    # input/timecode.c) ---
    tcmap = None
    if cli.get("tcfile_in"):
        from .io.timecode import TimecodeMap, TimecodeError
        tb_opt = None
        if cli.get("timebase"):
            t = cli["timebase"]
            if "/" in t:
                tn, td = t.split("/", 1)
                tb_opt = (int(tn), int(td))
            # plain integer with a tcfile = timebase numerator (the
            # reference help: "timebase numerator for input timecode
            # file"); the denominator stays auto-derived below
        try:
            tcmap = TimecodeMap(cli["tcfile_in"],
                                fallback_fps=(p.fps_num, p.fps_den),
                                timebase=tb_opt)
        except (OSError, TimecodeError) as e:
            logmod.error(str(e))
            return 2
        if cli.get("timebase") and "/" not in cli["timebase"]:
            n = int(cli["timebase"])
            tcmap.tb_num, tcmap.tb_den = n, tcmap.tb_den * n
        p.timebase_num, p.timebase_den = tcmap.tb_num, tcmap.tb_den
    elif cli.get("timebase"):
        logmod.error("--timebase is incompatible with cfr input")
        return 2
    tcout = None
    if cli.get("tcfile_out"):
        from .io.timecode import TimecodeWriter
        tn = p.timebase_num or p.fps_den
        td = p.timebase_den or p.fps_num
        tcout = TimecodeWriter(cli["tcfile_out"], tn, td)

    # --- qpfile: per-frame forced type/QP (reference parse_qpfile,
    # x264.c; format "<frame> <I|i|K|P|B|b> [qp]") ---
    qpfile: dict[int, tuple[int, int]] = {}
    if cli.get("qpfile"):
        from .encoder.encoder import (TYPE_B, TYPE_BREF, TYPE_I, TYPE_IDR,
                                      TYPE_KEYFRAME, TYPE_P)
        tmap = {"I": TYPE_IDR, "i": TYPE_I, "K": TYPE_KEYFRAME,
                "P": TYPE_P, "B": TYPE_BREF, "b": TYPE_B}
        try:
            with open(cli["qpfile"]) as qf:
                for line in qf:
                    parts = line.split()
                    if len(parts) < 2 or parts[0].startswith("#"):
                        continue
                    fno = int(parts[0])
                    ft = tmap.get(parts[1])
                    if ft is None:
                        print(f"x264-tpu [error]: bad qpfile type "
                              f"'{parts[1]}'", file=sys.stderr)
                        return 2
                    fqp = int(parts[2]) if len(parts) > 2 else -1
                    qpfile[fno] = (ft, fqp)
        except OSError as e:
            print(f"x264-tpu [error]: {e}", file=sys.stderr)
            return 2

    # --- encode loop (reference encode() x264.c:1923) ---
    enc = Encoder(p)
    out = open_output(known.output, getattr(known, "muxer", None))
    out.set_param(p)
    out.write_headers(enc.headers())
    dumper = None
    if p.dump_yuv:
        dumper = Y4MWriter(p.dump_yuv, VideoInfo(
            p.width, p.height, p.fps_num, p.fps_den, csp=p.csp))
    t0 = time.time()
    n = 0
    total_bytes = 0
    fed = 0

    def emit(nals, pic_out):
        """Write one access unit, mapping frame-index pts/dts to
        timebase ticks when a tcfile drives VFR timing."""
        pts, dts = pic_out.pts, pic_out.dts
        if tcmap is not None:
            pts, dts = tcmap.pts(pts), tcmap.pts(dts)
        if tcout is not None:
            tcout.add(pts)
        return out.write_frame(nals, pts=pts, dts=dts)
    for idx, planes in enumerate(reader):
        if idx < known.seek:
            continue
        if known.frames and fed >= known.frames:
            break
        fed += 1
        pic = Picture(planes, pts=idx)
        if fed - 1 in qpfile:
            pic.i_type, pic.forced_qp = qpfile[fed - 1]
        nals, pic_out = enc.encode(pic)
        if nals:
            total_bytes += emit(nals, pic_out)
        if dumper and pic_out is not None and pic_out.recon is not None:
            dumper.write_frame([np.asarray(r) for r in pic_out.recon])
        if pic_out is not None:
            n += 1
        if not known.quiet and not cli.get("no_progress") \
                and n % 10 == 0:
            el = time.time() - t0
            fps_now = n / el if el > 0 else 0
            kbps = total_bytes * 8 * (p.fps_num / p.fps_den) / max(n, 1) / 1000
            # progress ticker with %/ETA when the frame count is known
            # (reference print_status, x264.c:1875)
            total = known.frames or max(getattr(info, "num_frames", -1), 0)
            if total and fps_now > 0:
                pct = 100.0 * fed / total
                eta = max(total - fed, 0) / fps_now
                print(f"\r[{pct:5.1f}%] {n}/{total} frames, "
                      f"{fps_now:.2f} fps, {kbps:.2f} kb/s, "
                      f"eta {int(eta) // 60}:{int(eta) % 60:02d}",
                      end="", file=sys.stderr)
            else:
                print(f"\r{n} frames, {fps_now:.2f} fps, {kbps:.2f} kb/s",
                      end="", file=sys.stderr)
    # flush delayed frames (pipeline/lookahead)
    while enc.delayed_frames():
        nals, pic_out = enc.encode(None)
        if nals:
            total_bytes += emit(nals, pic_out)
        if pic_out is not None:
            if dumper and pic_out.recon is not None:
                dumper.write_frame([np.asarray(r) for r in pic_out.recon])
            n += 1
    el = time.time() - t0
    stats = enc.close()
    out.close()
    if tcout is not None:
        tcout.close()
    if dumper:
        dumper.close()
    reader.close()
    if not known.quiet:
        fps_avg = n / el if el > 0 else 0
        kbps = (total_bytes * 8 * (p.fps_num / p.fps_den)
                / max(n, 1) / 1000)
        print(f"\nencoded {n} frames, {fps_avg:.2f} fps, {kbps:.2f} kb/s",
              file=sys.stderr)
        for t in "IPB":
            c = stats["count"][t]
            if c:
                print(f"x264-tpu [info]: frame {t}:{c:<5} "
                      f"Avg QP:{stats['qp_sum'][t] / c:5.2f} "
                      f"size:{stats['bytes_by_type'][t] // c}",
                      file=sys.stderr)
        # MB-mode histogram (reference encoder_close, encoder.c:4247)
        for t, mbs in sorted(stats.get("mb", {}).items()):
            tot = max(mbs.get("total", 0), 1)
            parts = "  ".join(
                f"{k}:{100.0 * v / tot:5.1f}%"
                for k, v in mbs.items() if k != "total")
            print(f"x264-tpu [info]: mb {t}  {parts}", file=sys.stderr)
        if stats.get("psnr_frames"):
            npx = {0: p.width * p.height,
                   1: p.width * p.height // 4, 2: p.width * p.height // 4}
            import math
            vals = []
            for i in range(3):
                mse = stats["ssd"][i] / (npx[i] * stats["psnr_frames"])
                peak = (1 << p.bitdepth) - 1
                vals.append(10 * math.log10(peak * peak / mse)
                            if mse > 0 else 99.0)
            print(f"x264-tpu [info]: PSNR Mean Y:{vals[0]:.3f} "
                  f"U:{vals[1]:.3f} V:{vals[2]:.3f}", file=sys.stderr)
        if stats.get("ssim_frames"):
            print(f"x264-tpu [info]: SSIM Mean Y:"
                  f"{stats['ssim_sum'] / stats['ssim_frames']:.7f}",
                  file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
