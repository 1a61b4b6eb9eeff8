#!/usr/bin/env python3
"""Smoke test: the encoder's main path on one GPU, checked end to end.

Run from the root of the repository, on a host whose JAX sees a GPU:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  0. Device: JAX's devices, the card's name and power limit from
     nvidia-smi, the host's CPU count, the compile-cache directory, and a
     build of the native CABAC writer.
  1. GPU vs CPU identity at 320x192, 8 frames, for preset medium and for
     CAVLC IPPP at QP 26. The CPU side is the plain reference: the same
     encoder compiled by XLA for the CPU, run in a child process with
     JAX_PLATFORMS=cpu (it never opens the card), started first so that
     it overlaps the GPU work. Annex-B bytes and recon planes must be
     identical: the encoder is integer-exact.
  2. 1080p through the CLI (x264_tpu.cli.main) with --dump-yuv, for the
     same two configurations, 8 frames each, run cold and then warm.
     tools/refdec.py (pure numpy, in child processes) decodes each stream,
     which must equal the dumped recon bit for bit.
  3. Bring-up observations for later work, not benchmark results: the
     wavefront commit scan's time and device kernels per diagonal step,
     the gather vs one-hot window extraction at the three call sites'
     shapes, and the top device operations of one traced 1080p P frame.

The last line of stdout is {"ok": true, "device": {...}}. Without a GPU
the script exits with status 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 0
SMALL = (320, 192, 8)            # phase 1: width, height, frames
FULL = (1920, 1080, 8)           # phase 2
# encoder options on top of --preset medium, as (param name, value)
CONFIGS = {
    "medium": [],
    "cavlc_ippp_qp26": [("no-cabac", None), ("bframes", "0"), ("qp", "26")],
}
ME_RANGE = 16                    # --merange of preset medium


def check(cond, msg) -> None:
    """A failed check ends the run with an error (unlike assert, it is
    not skipped under python -O)."""
    if not cond:
        raise RuntimeError(msg)


def say(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def cli_args(opts) -> list:
    out = []
    for k, v in opts:
        out += [f"--{k}"] + ([] if v is None else [v])
    return out


def make_params(w, h, opts):
    from x264_tpu import param_default_preset, param_parse
    p = param_default_preset("medium")
    for k, v in opts:
        param_parse(p, k, v)
    p.width, p.height = w, h
    return p


def synth(n, w, h):
    from bench import synth_clip
    return synth_clip(n, w, h, seed=SEED)


# ---------------------------------------------------------------- phase 1
def encode_clip(frames, opts, device):
    """Encode `frames` with preset medium + `opts` through the Encoder API,
    with `device` as JAX's default device. Returns (Annex-B bytes, recon
    frames in coding order)."""
    import jax

    from x264_tpu.encoder.encoder import Encoder, Picture
    h, w = frames[0][0].shape
    p = make_params(w, h, opts)
    p.full_recon = True
    nals_all, recon = [], []
    with jax.default_device(device):
        enc = Encoder(p)

        def take(res):
            nals, out = res
            if out is not None:
                nals_all.extend(nals)
                recon.append([np.asarray(pl) for pl in out.recon])
        for i, f in enumerate(frames):
            take(enc.encode(Picture(f, pts=i)))
        while enc.delayed_frames():
            take(enc.encode(None))
        nals_all[:0] = enc.headers()
    data = b"".join(b"\x00\x00\x00\x01" + n.payload for n in nals_all)
    return data, recon


def identity_check(device, reference, w, h, n):
    """Encode the seeded w x h clip on `device` in every configuration and
    require the same bytes and recon as `reference(name, frames)`."""
    frames = synth(n, w, h)
    for name, opts in CONFIGS.items():
        t0 = time.perf_counter()
        data, recon = encode_clip(frames, opts, device)
        dt = time.perf_counter() - t0
        ref_data, ref_recon = reference(name, frames)
        check(data == ref_data,
              f"{name}: stream differs from the CPU reference "
              f"({len(data)} vs {len(ref_data)} bytes)")
        check(len(recon) == len(ref_recon) == n,
              f"{name}: {len(recon)} vs {len(ref_recon)} recon frames")
        for i, (a, b) in enumerate(zip(recon, ref_recon)):
            for pi in range(3):
                check(np.array_equal(a[pi], b[pi]),
                      f"{name}: recon frame {i} plane {pi} differs")
        say({"phase": 1, "config": name, "size": f"{w}x{h}",
             "frames": n, "bytes": len(data), "identical": True,
             "device": device.platform,
             "encode_s_incl_compile": round(dt, 3)})


def cpu_reference_main(out_path, w, h, n):
    """Child process (JAX_PLATFORMS=cpu): the CPU side of phase 1."""
    import jax
    dev = jax.devices()[0]
    check(dev.platform == "cpu", f"reference child on {dev.platform}")
    frames = synth(n, w, h)
    arrays = {}
    for name, opts in CONFIGS.items():
        data, recon = encode_clip(frames, opts, dev)
        arrays[f"{name}/bytes"] = np.frombuffer(data, np.uint8)
        for i, fr in enumerate(recon):
            for pi, pl in enumerate(fr):
                arrays[f"{name}/{i}/{pi}"] = pl
    np.savez(out_path, **arrays)
    return 0


def load_cpu_reference(path, n):
    z = np.load(path)

    def reference(name, _frames):
        data = z[f"{name}/bytes"].tobytes()
        recon = [[z[f"{name}/{i}/{pi}"] for pi in range(3)]
                 for i in range(n) if f"{name}/{i}/0" in z]
        return data, recon
    return reference


# ---------------------------------------------------------------- phase 2
def write_y4m(path, frames):
    from x264_tpu.io.y4m import VideoInfo, Y4MWriter
    h, w = frames[0][0].shape
    wr = Y4MWriter(path, VideoInfo(w, h, 30, 1))
    for f in frames:
        wr.write_frame(f)
    wr.close()


def read_y4m(path):
    from x264_tpu.io.y4m import Y4MReader
    r = Y4MReader(path)
    try:
        return [list(f) for f in r]
    finally:
        r.close()


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def weighted_psnr(src, rec):
    """x264-style (6 Y + U + V) / 8 per-frame PSNR."""
    vals = []
    for a, b in zip(src, rec):
        d = a.astype(np.float64) - b.astype(np.float64)
        vals.append(10 * np.log10(255.0 ** 2 / max((d * d).mean(), 1e-12)))
    return (6 * vals[0] + vals[1] + vals[2]) / 8


def refdec_check_main(stream, recon, source):
    """Child process: decode `stream` with tools/refdec.py, require it to
    equal the dumped recon, and report PSNR of the recon vs `source`
    (frames paired by picture order count)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import refdec

    class PocDecoder(refdec.Decoder):
        def _finish_frame(self, y, u, v):
            self.pocs.append(getattr(self, "_cur_poc", 0))
            super()._finish_frame(y, u, v)

    t0 = time.perf_counter()
    dec = PocDecoder()
    dec.pocs = []
    frames = dec.decode(read_bytes(stream))
    dt = time.perf_counter() - t0
    rec = read_y4m(recon)
    src = read_y4m(source)
    check(len(frames) == len(rec) == len(src),
          f"{stream}: {len(frames)} decoded, {len(rec)} recon, "
          f"{len(src)} source frames")
    for i, (a, b) in enumerate(zip(frames, rec)):
        for pi in range(3):
            check(np.array_equal(a[pi], b[pi]),
                  f"{stream}: refdec frame {i} plane {pi} != recon")
    display = np.argsort(np.argsort(dec.pocs, kind="stable"))
    psnr = float(np.mean([weighted_psnr(src[int(display[i])], rec[i])
                          for i in range(len(rec))]))
    say({"frames": len(frames), "bit_exact": True, "psnr": psnr,
         "refdec_s": round(dt, 1)})
    return 0


def cli_encode(src, out, rec, n, opts):
    """x264_tpu.cli.main on one configuration; returns wall seconds. The
    CLI writes every NAL and recon frame before it returns, so this
    time covers all device work."""
    from x264_tpu import cli
    argv = ([src, "-o", out, "--frames", str(n), "--dump-yuv", rec,
             "--preset", "medium", "--quiet"] + cli_args(opts))
    t0 = time.perf_counter()
    rc = cli.main(argv)
    dt = time.perf_counter() - t0
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    return dt


def spawn(args, log_prefix):
    """Start this script as a child with `args` on the CPU backend; its
    stdout and stderr go to files so that it never blocks on a pipe."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = open(log_prefix + ".out", "w+")
    err = open(log_prefix + ".err", "w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__)]
                            + args, env=env, stdout=out, stderr=err,
                            text=True)
    proc.logs = (out, err)
    return proc


def collect(proc, what, timeout):
    """Wait for a child from spawn(); return its stdout or raise."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"{what}: no result within {timeout} s")
    out, err = proc.logs
    out.seek(0)
    err.seek(0)
    text, errs = out.read(), err.read()
    out.close()
    err.close()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (rc={proc.returncode}):\n"
                           f"{errs[-3000:]}")
    return text


def full_width_encodes(device, workdir, w, h, n, children):
    """Phase 2: both configurations through the CLI, cold then warm; the
    refdec checks start as child processes and are collected later."""
    frames = synth(n, w, h)
    src = os.path.join(workdir, f"src_{w}x{h}.y4m")
    write_y4m(src, frames)
    for name, opts in CONFIGS.items():
        out = os.path.join(workdir, f"{name}.264")
        rec = os.path.join(workdir, f"{name}_recon.y4m")
        cold = cli_encode(src, out, rec, n, opts)
        first = read_bytes(out)
        warm = cli_encode(src, out, rec, n, opts)
        data = read_bytes(out)
        check(data == first, f"{name}: warm run wrote different bytes")
        stats = device.memory_stats() or {}
        say({"phase": 2, "config": name, "size": f"{w}x{h}", "frames": n,
             "entry": "x264_tpu.cli.main", "bytes": len(data),
             "cold_s": round(cold, 3), "warm_encode_s": round(warm, 3),
             "setup_s": round(cold - warm, 3),
             "warm_fps": round(n / warm, 3),
             "peak_bytes_in_use": stats.get("peak_bytes_in_use")})
        children.append((name, spawn(["--refdec-check", out, rec, src],
                                     os.path.join(workdir, name))))


# ---------------------------------------------------------------- phase 3
def time_ms(fn, reps=5):
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": round(statistics.median(ts), 3),
            "min_ms": round(min(ts), 3)}


def traced(fn, trace_dir):
    import jax

    from x264_tpu.utils import devtrace
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn())
    lines = devtrace.load_device_lines(trace_dir)
    summary = devtrace.summarize(devtrace.kernel_events(lines))
    summary["lines"] = {f"{pl} | {ln}": len(evs)
                        for (pl, ln), evs in lines.items()}
    return summary


def commit_findings(workdir, gpu, w=1920, h=1088):
    """commit_scan at 1080p (MB-padded): an I frame with I_4x4 (as in
    medium) and a P frame whose intra MBs (10%, seeded) mix with an inter
    recon."""
    import jax
    import jax.numpy as jnp

    from x264_tpu.encoder.intra import commit_scan, i_stage_decide
    from x264_tpu.ops import skew
    from x264_tpu.ops.tables import chroma_qp
    mbw, mbh = w // 16, h // 16
    frames = synth(2, w, h)
    y, u, v = (jnp.asarray(p) for p in frames[1])
    qp_np = np.full((mbh, mbw), 26, np.int32)
    qp = jnp.asarray(qp_np)
    qpc = jnp.asarray(np.asarray(chroma_qp(qp_np), np.int32))
    i16, cm, _, i4_mask, i4_modes = i_stage_decide(y, u, v, qp, i4=True)
    rng = np.random.default_rng(SEED)
    is_intra = jnp.asarray(rng.random((mbh, mbw)) < 0.1)
    inter = tuple(jnp.asarray(p) for p in frames[0])
    scan = jax.jit(commit_scan, static_argnames=("mbw", "mbh"))
    cases = {
        "I_frame_i4": dict(i4_mask=i4_mask, i4_modes=i4_modes),
        "P_frame_intra_in_p": dict(is_intra=is_intra, inter_planes=inter,
                                   i4_mask=i4_mask, i4_modes=i4_modes),
    }
    D = skew.n_diags(mbw, mbh)
    for name, kw in cases.items():
        def fn(kw=kw):
            return scan(y, u, v, i16, cm, qp, qpc, mbw=mbw, mbh=mbh, **kw)
        t = time_ms(fn)
        tr = traced(fn, os.path.join(workdir, f"trace_commit_{name}"))
        say({"phase": 3, "finding": "commit_scan", "case": name,
             "size": f"{w}x{h}", "diagonals": D, **t,
             "device_kernels": tr["kernels"],
             "kernels_per_diagonal": round(tr["kernels"] / D, 2),
             "device_busy_ms": round(tr["busy_ms"], 3), "gpu": gpu,
             "note": "bring-up observation, not a benchmark result"})


def warp_findings(gpu, mbw=120, mbh=68):
    """Gather vs one-hot window extraction at the 1080p shapes of the
    three call sites (inter._subpel_windows, inter.chroma_mc_warp,
    bdirect.direct_pred_luma), medium's merange, seeded offsets."""
    import jax
    import jax.numpy as jnp

    from x264_tpu.encoder.inter import SUBPEL_MARG, SUBPEL_WIN
    from x264_tpu.ops import mc
    from x264_tpu.ops.warp import mb_windows, mb_windows_onehot
    rng = np.random.default_rng(SEED)
    hpel = jnp.asarray(rng.integers(0, 256, (4, mbh * 16 + 2 * mc.PAD,
                                             mbw * 16 + 2 * mc.PAD),
                                    dtype=np.uint8))
    cpads = jnp.asarray(rng.integers(0, 256, (2, mbh * 8 + 2 * mc.CPAD,
                                              mbw * 8 + 2 * mc.CPAD),
                                     dtype=np.uint8))
    R, qr = ME_RANGE, 3          # merange; qpel refine radius
    sites = {   # name: (planes, bs, lo, hi, win, pad)
        "subpel_win24": (hpel, 16, -R - SUBPEL_MARG, R - SUBPEL_MARG,
                         SUBPEL_WIN, mc.PAD),
        "chroma_mc_win9": (cpads, 8, -((4 * R + qr + 7) >> 3),
                           (4 * R + qr) >> 3, 9, mc.CPAD),
        "bdirect_win21": (hpel, 16, -R - 2, R - 2, 21, mc.PAD),
    }
    for name, (planes, bs, lo, hi, win, pad) in sites.items():
        off = jnp.asarray(rng.integers(lo, hi + 1, (mbh, mbw, 2),
                                       dtype=np.int32))
        gather = jax.jit(lambda pl, o, bs=bs, win=win, pad=pad:
                         mb_windows(pl, o, bs=bs, win=win, pad=pad))
        onehot = jax.jit(lambda pl, o, bs=bs, lo=lo, hi=hi, win=win,
                         pad=pad: mb_windows_onehot(pl, o, bs=bs, lo=lo,
                                                    hi=hi, win=win,
                                                    pad=pad))
        a = gather(planes, off)
        b = onehot(planes, off)
        check(np.array_equal(np.asarray(a), np.asarray(b)),
              f"{name}: one-hot windows differ from the gather")
        say({"phase": 3, "finding": "warp", "site": name,
             "planes": int(planes.shape[0]), "win": win,
             "gather": time_ms(lambda: gather(planes, off), reps=10),
             "onehot": time_ms(lambda: onehot(planes, off), reps=10),
             "gpu": gpu,
             "note": "bring-up observation, not a benchmark result"})


def p_frame_findings(workdir, gpu, w, h):
    """Top device operations of one 1080p P frame, CAVLC IPPP QP 26 (the
    bench's configuration), encoded synchronously (threads=1) with forced
    frame types so the traced call holds exactly that frame."""
    from x264_tpu.encoder.encoder import TYPE_IDR, TYPE_P, Encoder, Picture
    frames = synth(3, w, h)
    p = make_params(w, h, CONFIGS["cavlc_ippp_qp26"] + [("threads", "1")])
    enc = Encoder(p)
    for i, t in ((0, TYPE_IDR), (1, TYPE_P)):
        nals, _ = enc.encode(Picture(frames[i], pts=i, i_type=t))
        check(nals, f"frame {i} was not emitted synchronously")
    out = {}

    def one_p():
        t0 = time.perf_counter()
        out["nals"], _ = enc.encode(Picture(frames[2], pts=2,
                                            i_type=TYPE_P))
        out["s"] = time.perf_counter() - t0
        return 0
    tr = traced(one_p, os.path.join(workdir, "trace_pframe"))
    check(out["nals"], "traced P frame was not emitted")
    say({"phase": 3, "finding": "p_frame_trace", "size": f"{w}x{h}",
         "frame_wall_ms_traced": round(out["s"] * 1e3, 3),
         "device_kernels": tr["kernels"],
         "device_busy_ms": round(tr["busy_ms"], 3),
         "device_span_ms": round(tr["span_ms"], 3),
         "trace_lines": tr["lines"],
         "top": [{"name": t["name"][:80], "count": t["count"],
                  "ms": round(t["ms"], 3)} for t in tr["top"]],
         "gpu": gpu, "note": "bring-up observation, not a benchmark result"})


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # internal: the child processes this script starts
    ap.add_argument("--cpu-reference", metavar="OUT_NPZ",
                    help=argparse.SUPPRESS)
    ap.add_argument("--refdec-check", nargs=3,
                    metavar=("STREAM", "RECON", "SOURCE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        return cpu_reference_main(args.cpu_reference, *SMALL)
    if args.refdec_check:
        return refdec_check_main(*args.refdec_check)

    from x264_tpu.utils.device import (device_record,
                                       nvidia_smi_name_power, require_gpu)
    dev = require_gpu("chip_smoke.py")
    t_start = time.perf_counter()
    children = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        try:
            # phase 1's CPU reference starts first so it overlaps the rest
            ref_npz = os.path.join(workdir, "cpu_reference.npz")
            children.append(("cpu", spawn(["--cpu-reference", ref_npz],
                                          os.path.join(workdir, "cpu"))))

            # ---- phase 0
            from x264_tpu.entropy import cabac_host
            from x264_tpu.utils.jaxcache import enable_compile_cache
            gpu = nvidia_smi_name_power()
            cache = enable_compile_cache()
            t0 = time.perf_counter()
            cabac_host._load()
            say({"phase": 0, "device": device_record(), "gpu": gpu,
                 "cpu_count": os.cpu_count(), "compile_cache": cache,
                 "native_cabac_load_s":
                     round(time.perf_counter() - t0, 3)})
            say(f"gpu: {gpu}")

            # ---- phase 1 (the CPU side is waited for at first use)
            w, h, n = SMALL
            loaded = {}

            def reference(name, frames):
                if not loaded:
                    collect(children.pop(0)[1], "CPU reference encode",
                            timeout=900)
                    loaded["ref"] = load_cpu_reference(ref_npz, n)
                return loaded["ref"](name, frames)
            identity_check(dev, reference, w, h, n)
            say({"phase": 1, "done_s":
                 round(time.perf_counter() - t_start, 1)})

            # ---- phase 2
            w, h, n = FULL
            full_width_encodes(dev, workdir, w, h, n, children)
            say({"phase": 2, "encodes_done_s":
                 round(time.perf_counter() - t_start, 1)})

            # ---- phase 3
            commit_findings(workdir, gpu)
            warp_findings(gpu)
            p_frame_findings(workdir, gpu, w, h)
            say({"phase": 3, "done_s":
                 round(time.perf_counter() - t_start, 1)})

            # ---- phase 2's refdec checks
            while children:
                name, proc = children.pop(0)
                res = json.loads(collect(proc, f"refdec check of {name}",
                                         timeout=900).strip()
                                 .splitlines()[-1])
                say({"phase": 2, "config": name,
                     "decoder": "tools/refdec.py", **res})
        finally:
            for _, proc in children:
                proc.kill()
                proc.wait()
    say({"elapsed_s": round(time.perf_counter() - t_start, 1), "gpu": gpu})
    say({"ok": True, "device": device_record()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
