"""Multi-device sharding tests on a virtual CPU mesh: the (stream, band)
mapping of the reference's frame/sliced threads (SURVEY.md §2.9,
threaded_slices_write encoder.c:3219). Conformance: the assembled
multi-slice bitstream must decode bit-exactly (libavcodec oracle)."""

import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")
AVDEC = os.path.join(TOOLS, "avdec")


def _ensure_avdec():
    if os.path.exists(AVDEC):
        return True
    r = subprocess.run(
        ["gcc", "-O2", os.path.join(TOOLS, "avdec.c"), "-o", AVDEC,
         "-lavcodec", "-lavutil"], capture_output=True)
    return r.returncode == 0


def _cpu_mesh(n):
    import jax

    from x264_tpu.parallel.mesh import make_mesh
    cpus = jax.devices("cpu")
    if len(cpus) < n:
        pytest.skip(f"only {len(cpus)} cpu devices (XLA_FLAGS not applied)")
    return make_mesh(n, devices=cpus[:n])


def synth_frames(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(128 + 60 * np.sin((xx + 2 * i) / 23) * np.cos(yy / 17)
                    + rng.integers(-6, 6, (h, w)), 0, 255).astype(np.uint8)
        u = np.clip(128 + 40 * np.sin(xx[::2, ::2] / 31 + i), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + 40 * np.cos(yy[::2, ::2] / 29 - i), 0,
                    255).astype(np.uint8)
        out.append([y, u, v])
    return out


def _decode_avdec(stream, w, h, nframes, tmp_path, name):
    f264 = tmp_path / f"{name}.264"
    f264.write_bytes(stream)
    out = tmp_path / f"{name}.yuv"
    r = subprocess.run([AVDEC, str(f264), str(out), str(nframes * 4)],
                       capture_output=True, text=True)
    assert "error" not in r.stderr.lower(), r.stderr
    raw = out.read_bytes()
    fsz = w * h * 3 // 2
    assert len(raw) >= nframes * fsz, (len(raw), nframes * fsz)
    frames = []
    for i in range(nframes):
        fr = raw[i * fsz:(i + 1) * fsz]
        fy = np.frombuffer(fr[:w * h], np.uint8).reshape(h, w)
        fu = np.frombuffer(fr[w * h:w * h * 5 // 4],
                           np.uint8).reshape(h // 2, w // 2)
        fv = np.frombuffer(fr[w * h * 5 // 4:], np.uint8).reshape(
            h // 2, w // 2)
        frames.append((fy, fu, fv))
    return frames


def _stack_bands(recon_bands, s):
    """recon tuple of [S,NB,bandH,W] arrays -> per-stream full planes."""
    return [np.concatenate(np.asarray(r[s]), axis=0) for r in recon_bands]


def test_make_mesh_shapes():
    mesh = _cpu_mesh(8)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("stream", "band")


def test_make_mesh_never_switches_backend(monkeypatch):
    """Too few default-backend devices is an error, even when another
    backend (here the 8 virtual CPU devices) has enough."""
    import jax

    from x264_tpu.parallel import mesh as mesh_mod
    real = jax.devices
    cpus = real("cpu")
    assert len(cpus) >= 4

    def devices(backend=None):
        return cpus if backend == "cpu" else cpus[:1]
    monkeypatch.setattr(mesh_mod.jax, "devices", devices)
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        mesh_mod.make_mesh(4)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        mesh_mod.make_mesh(4, devices=cpus[:2])


def test_sharded_intra_multislice_conformance(tmp_path):
    """2 streams x 4 slice bands on 8 virtual devices; assembled multi-slice
    IDR stream decodes bit-exactly in libavcodec."""
    if not _ensure_avdec():
        pytest.skip("libavcodec not available")
    from x264_tpu import param_default_preset
    from x264_tpu.encoder.encoder import validate_parameters
    from x264_tpu.entropy import sets
    from x264_tpu.entropy.nal import annexb_bytes, nal_encode, NAL_SPS, \
        NAL_PPS, NAL_PRIORITY_HIGHEST
    from x264_tpu.parallel.mesh import (assemble_band_nals,
                                        sharded_intra_encode)

    mesh = _cpu_mesh(8)
    s, nb = mesh.devices.shape
    w, band_mb_rows = 64, 2
    h = nb * band_mb_rows * 16
    frames = synth_frames(s, w, h, seed=2)
    out = sharded_intra_encode(mesh, frames, qp=28,
                               band_mb_rows=band_mb_rows)
    words, total_bits, recon, _ = out
    words = np.asarray(words)
    total_bits = np.asarray(total_bits)

    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.cabac = False
    p.bframe = 0     # IPPP: refdec has no B decode yet
    p.rc.rc_method = 0
    p.rc.qp_constant = 28
    p = validate_parameters(p)
    sps = sets.sps_init(p, p.sps_id)
    pps = sets.pps_init(p, sps, p.sps_id)
    hdr = annexb_bytes([
        nal_encode(NAL_SPS, NAL_PRIORITY_HIGHEST, sets.sps_write(sps)),
        nal_encode(NAL_PPS, NAL_PRIORITY_HIGHEST, sets.pps_write(pps))])
    for si in range(s):
        nals = assemble_band_nals(p, words[si], total_bits[si],
                                  band_mb_rows=band_mb_rows, slice_qp=28,
                                  deblock_idc=1)
        stream = hdr + annexb_bytes(nals)
        dec = _decode_avdec(stream, w, h, 1, tmp_path, f"mesh_i{si}")
        rec = _stack_bands(recon, si)
        for c in range(3):
            np.testing.assert_array_equal(dec[0][c], rec[c],
                                          err_msg=f"stream {si} plane {c}")


@pytest.mark.slow
def test_sharded_pframe_multislice_conformance(tmp_path):
    """Stream-parallel P frames in slice bands (deblock idc=2) decode
    bit-exactly after a single-slice IDR."""
    if not _ensure_avdec():
        pytest.skip("libavcodec not available")
    from x264_tpu import param_default_preset
    from x264_tpu.encoder.encoder import (Encoder, Picture, TYPE_IDR,
                                          validate_parameters)
    from x264_tpu.entropy.nal import annexb_bytes
    from x264_tpu.parallel.mesh import (assemble_band_nals,
                                        sharded_pframe_encode)

    mesh = _cpu_mesh(8)
    s, nb = mesh.devices.shape
    w, band_mb_rows = 64, 2
    h = nb * band_mb_rows * 16
    qp = 28
    all_frames = synth_frames(2 * s, w, h, seed=9)

    p = param_default_preset("medium")
    p.width, p.height = w, h
    p.cabac = False
    p.bframe = 0     # IPPP: refdec has no B decode yet
    p.deblocking_filter = True
    p.rc.rc_method = 0
    p.rc.qp_constant = qp
    p.full_recon = True
    p.threads = 1
    p = validate_parameters(p)

    streams, i_recons = [], []
    encs = []
    for si in range(s):
        enc = Encoder(p.copy())
        stream = annexb_bytes(enc.headers())
        nals, out = enc.encode(Picture(all_frames[si], pts=0,
                                       i_type=TYPE_IDR))
        stream += annexb_bytes(nals)
        streams.append(stream)
        i_recons.append(out.recon)
        encs.append(enc)

    p_frames = [all_frames[s + si] for si in range(s)]
    pout = sharded_pframe_encode(mesh, p_frames, i_recons, qp=qp,
                                 band_mb_rows=band_mb_rows)
    words, total_bits = np.asarray(pout[0]), np.asarray(pout[1])
    recon = pout[2]
    for si in range(s):
        nals = assemble_band_nals(p, words[si], total_bits[si],
                                  band_mb_rows=band_mb_rows, slice_qp=qp,
                                  frame_num=1, poc=2, idr=False, ptype=True,
                                  deblock_idc=2)
        stream = streams[si] + annexb_bytes(nals)
        dec = _decode_avdec(stream, w, h, 2, tmp_path, f"mesh_p{si}")
        rec = _stack_bands(recon, si)
        for c in range(3):
            np.testing.assert_array_equal(dec[1][c], rec[c],
                                          err_msg=f"stream {si} plane {c}")
