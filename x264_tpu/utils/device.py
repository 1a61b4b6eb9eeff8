"""The accelerator a measurement runs on.

Every measured number is reported beside the device it came from. A
measurement path that finds no GPU stops; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import sys


def nvidia_smi_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or why they could not be read."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({type(e).__name__}: {e})"
    out = r.stdout.strip()
    return out if r.returncode == 0 and out else \
        f"unavailable (rc={r.returncode}: {r.stderr.strip()[:200]})"


def require_gpu(what: str):
    """Return JAX's first device if it is a GPU; otherwise print why on
    stderr and exit with status 2."""
    import jax
    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        plat = devs[0].platform if devs else "none"
        print(f"{what}: needs a GPU, but JAX's default backend is "
              f"'{plat}'", file=sys.stderr)
        raise SystemExit(2)
    return devs[0]


def device_record() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
