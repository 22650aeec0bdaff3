"""Profiling helpers (SURVEY.md §5.1): trace capture + per-op device-time
attribution.

The reference's only observability is println of config at load
(rusty_vit.rs:90-95).  Here: `capture(fn, *args)` records a jax.profiler
trace around a few executions and `op_breakdown(trace_dir)` parses the
exported Chrome trace into grouped device-time per HLO-op class — the tool
that drove every perf decision in BASELINE.md.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import re
from typing import Callable, Dict

import jax


def capture(fn: Callable, *args, trace_dir: str = "/tmp/vitrs_trace",
            iters: int = 3) -> str:
    """Run fn(*args) `iters` times under the profiler. Returns trace_dir."""
    jax.block_until_ready(fn(*args))      # compile outside the trace
    jax.profiler.start_trace(trace_dir)
    res = None
    for _ in range(iters):
        res = fn(*args)
    jax.block_until_ready(res)
    jax.profiler.stop_trace()
    return trace_dir


def op_breakdown(trace_dir: str, iters: int = 3,
                 top: int = 20) -> Dict[str, float]:
    """Parse the newest trace under trace_dir; returns {op-group: ms/step}."""
    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    with gzip.open(paths[-1]) as f:
        tr = json.load(f)
    dur: collections.Counter = collections.Counter()
    for e in tr.get("traceEvents", []):
        name = e.get("name", "")
        if e.get("ph") == "X" and "dur" in e and not name.startswith(("$", "np.")):
            dur[name] += e["dur"]
    grouped: collections.Counter = collections.Counter()
    for name, d in dur.items():
        grouped[re.sub(r"[.\d]+$", "", name) or "(anon)"] += d
    out = {g: round(d / (iters * 1e3), 3) for g, d in grouped.most_common(top)}
    return out


def print_breakdown(fn: Callable, *args, iters: int = 3,
                    trace_dir: str = "/tmp/vitrs_trace") -> Dict[str, float]:
    d = capture(fn, *args, trace_dir=trace_dir, iters=iters)
    bd = op_breakdown(d, iters=iters)
    for g, ms in bd.items():
        print(f"{ms:9.3f} ms  {g}")
    return bd
