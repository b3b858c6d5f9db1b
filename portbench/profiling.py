"""Reading a ``torch.profiler`` trace: the device's busy time, the time
of each kernel, and where the device sat idle.

The traced segment runs inside one ``record_function`` span,
:data:`WINDOW`; its length is the traced window.  Busy time is the union
of the device's kernel, copy and set intervals inside it.  Each idle gap
is named by what the host was doing at its middle: the innermost host
span of the harness (the mode's ``SPANS``) and the innermost operator.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

__all__ = ["WINDOW", "short_name", "read"]

WINDOW = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameter list."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void ", "", s)
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):       # cut at the first '(' outside <...>
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    s = s[:cut]
    s = re.sub(r"<.*>", "", s)
    return s.split("::")[-1].strip() or name


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t):
    """Name of the shortest span of ``spans`` ((start, end, name)) that
    holds time ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else None


def read(prof) -> dict:
    """``busy_s``, ``window_s``, ``kernel_s`` (device seconds by short
    kernel name) and ``breakdown`` (the ten device operations that took
    most time, and the ten longest idle gaps by host activity) of the
    segment ``prof`` traced."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in xs if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_s, ops_s = [], {}, {}
    for e in xs:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = short_name(e["name"])
        if e["cat"] == "kernel":
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
        ops_s[name] = ops_s.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in xs if e.get("cat") == "user_annotation"
             and e["name"] != WINDOW]
    host_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                for e in xs if e.get("cat") == "cpu_op"]
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((a - t, (a + t) / 2))
        t = max(t, b)
    gaps.sort(reverse=True)
    idle = []
    for length, mid in gaps[:10]:
        span = _innermost(spans, mid) or "outside the program's spans"
        op = _innermost(host_ops, mid) or "python"
        idle.append([f"{span} / {op}", length * 1e-6])
    top = sorted(ops_s.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": idle}}
