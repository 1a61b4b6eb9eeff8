"""chip_smoke.py off the card: its phase-1 identity check on explicit CPU
devices at a tiny size, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402


def test_identity_check_on_cpu_devices(capsys):
    """Phase 1 at 48x32, 2 frames, both configurations, with the CPU as
    the device under test; the reference side also decodes bit-exactly
    with tools/refdec.py."""
    import jax
    import refdec
    cpu = jax.devices("cpu")[0]
    checked = []

    def reference(name, frames):
        data, recon = chip_smoke.encode_clip(frames, chip_smoke.CONFIGS[name],
                                             cpu)
        dec = refdec.Decoder().decode(data)
        assert len(dec) == len(recon) == len(frames)
        for a, b in zip(dec, recon):
            for pi in range(3):
                np.testing.assert_array_equal(a[pi], b[pi])
        checked.append(name)
        return data, recon

    chip_smoke.identity_check(cpu, reference, 48, 32, 2)
    assert checked == list(chip_smoke.CONFIGS)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert [ln["config"] for ln in lines] == checked
    assert all(ln["identical"] and ln["device"] == "cpu" for ln in lines)


def test_main_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    out, err = capsys.readouterr()
    assert out == ""
    assert "needs a GPU" in err


def test_alone_without_repo_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
