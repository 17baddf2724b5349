"""The accelerator a measurement runs on, and wall-clock timing on it.

Every timed number this repository prints names its device: JAX's view
(platform, device kind, count) and the card's name and power limit as
``nvidia-smi`` reports them.  A measurement path that finds no GPU stops;
it never falls back to the CPU.
"""

from __future__ import annotations

import statistics
import subprocess
import time


def card_info() -> str:
    """``name, power.limit`` of the first card, read by ``nvidia-smi`` in a
    child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def require_gpu() -> dict:
    """JAX's first device as {platform, kind, count}; SystemExit unless it
    is a GPU."""
    import jax

    devs = jax.devices()
    d = {"platform": devs[0].platform, "kind": devs[0].device_kind,
         "count": len(devs)}
    if d["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {d}")
    return d


def time_calls(fn, args_list, reps: int = 5):
    """Median, min and max seconds of ``fn(*args)`` over ``reps`` calls,
    each ended by ``block_until_ready``, after one warm-up call (which
    compiles).  ``args_list`` holds one argument tuple per rep, cycled."""
    import jax

    jax.block_until_ready(fn(*args_list[0]))
    ts = []
    for i in range(reps):
        args = args_list[i % len(args_list)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), min(ts), max(ts)
