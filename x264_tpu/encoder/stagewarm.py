"""Concurrent stage-program warmup (r4 verdict item 4: compile time).

The per-frame device pipelines are split into stage programs, each under
its own jit (encoder/inter.py encode_pframe_staged, encoder/intra.py
encode_iframe_staged). First-use compilation of the stages would still
be SERIAL if triggered by encoding a frame, because stage k+1 cannot be
dispatched until stage k's jit has compiled and run. This module makes
warmup concurrent instead:

 1. PLAN: run the normal dispatch path under a StagePlan context. Each
    stage call is recorded (function, args, static kwargs) and answered
    with zeros of the correct output shape via jax.eval_shape — no
    compilation happens, so planning costs only tracing (seconds).
 2. WARM: replay every recorded call in its own thread, so independent
    XLA compilations can overlap instead of running one after another.

The recorded args are the exact arrays the planner produced, so the jit
cache keys match the real encode's calls (same shapes, dtypes, weak
types, statics)."""

from __future__ import annotations

import threading

_ACTIVE: "StagePlan | None" = None


class StagePlan:
    """Context manager that records stage-jit calls instead of running
    them. Single-threaded use (Encoder.precompile's planning pass)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        global _ACTIVE
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False


def stage(fn):
    """Stage-call indirection: identity normally; under an active
    StagePlan, a recording shim that returns shape-correct zeros."""
    plan = _ACTIVE
    if plan is None:
        return fn

    def shim(*args, **kw):
        import jax
        import jax.numpy as jnp
        plan.calls.append((fn, args, kw))
        out = jax.eval_shape(lambda *a: fn(*a, **kw), *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), out)

    return shim


def _call_key(fn, args, kw):
    import jax

    def leaf(x):
        if hasattr(x, "shape") and hasattr(x, "dtype"):
            return (tuple(x.shape), str(x.dtype))
        return repr(x)

    return (id(fn), str(jax.tree.map(leaf, args)),
            str(sorted(kw.items())))


def warm_calls(calls, max_threads: int = 12):
    """Compile+run every recorded stage call, deduped, concurrently.
    Raises the first error (a warm failure means the real encode would
    fail too)."""
    import jax
    seen = set()
    unique = []
    for fn, args, kw in calls:
        k = _call_key(fn, args, kw)
        if k in seen:
            continue
        seen.add(k)
        unique.append((fn, args, kw))
    errs = []
    sem = threading.Semaphore(max_threads)

    import os
    import time
    verbose = os.environ.get("X264_TPU_WARM_DEBUG") == "1"

    def run(fn, args, kw):
        with sem:
            t0 = time.time()
            try:
                jax.block_until_ready(fn(*args, **kw))
                if verbose:
                    name = getattr(fn, "__name__", str(fn))
                    print(f"[warm] {name} {time.time()-t0:.1f}s",
                          flush=True)
            except Exception as e:      # noqa: BLE001
                errs.append(e)

    threads = [threading.Thread(target=run, args=c) for c in unique]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return len(unique)
