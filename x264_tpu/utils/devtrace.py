"""Reduce a jax.profiler trace to device-side numbers.

`jax.profiler.trace(dir)` writes `<dir>/plugins/profile/<run>/*.xplane.pb`.
On a GPU the device planes are named "/device:GPU:<n>"; their "Stream"
lines hold one event per kernel or copy the device ran.
"""

from __future__ import annotations

import glob
import os
from collections import defaultdict


def load_device_lines(trace_dir: str, plane_prefix: str = "/device:"):
    """{(plane, line): [(name, start_ns, duration_ns), ...]} for every
    line of every plane whose name starts with `plane_prefix`, from the
    newest xplane file under `trace_dir`."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            out[(plane.name, line.name)] = [
                (e.name, e.start_ns, e.duration_ns) for e in line.events]
    return out


def kernel_events(lines: dict) -> list:
    """Events of the lines that carry device work: the "Stream" lines when
    there are any, else every line given."""
    stream = [evs for (_, ln), evs in lines.items() if "Stream" in ln]
    chosen = stream if stream else list(lines.values())
    return [e for evs in chosen for e in evs]


def summarize(events: list, top: int = 15) -> dict:
    """Kernel count, busy time (union of intervals), window span, and the
    `top` names by summed duration, all in ms."""
    if not events:
        return {"kernels": 0, "busy_ms": 0.0, "span_ms": 0.0, "top": []}
    ivs = sorted((s, s + d) for _, s, d in events)
    busy = 0.0
    cur_s, cur_e = ivs[0]
    for s, e in ivs[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = defaultdict(lambda: [0, 0.0])
    for name, _, d in events:
        by_name[name][0] += 1
        by_name[name][1] += d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "kernels": len(events),
        "busy_ms": busy / 1e6,
        "span_ms": (max(e for _, e in ivs) - ivs[0][0]) / 1e6,
        "top": [{"name": n, "count": c, "ms": t / 1e6}
                for n, (c, t) in ranked],
    }
