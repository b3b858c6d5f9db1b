"""The benchmark's general runner: one run of one cell of
``BENCHMARK.json``.

A run loads the cell's configuration (``configs/<config>.json``) and
traffic mix (``traffic/<mix>.json``), and drives the mix's mode
(``modes/<mode>.py``, named by the mix) through four steps: set-up, the
measured window, in a traced run one segment under ``torch.profiler``,
and the check against the plain reference in ``reference/``.  Every one
of these files is found by the name that ``BENCHMARK.json`` gives, so a
new configuration, mix, per-layer metric (``metrics/<name>.py``, or
``metrics/<quantity>.py`` for ``<quantity>.<cell kind>``) or kernel
roofline (``rooflines/<kernel>.py`` for ``<kernel>_roofline``) is a new
file, never an edit.

A mode module has::

    SPANS                      # (module, function) pairs: host spans
    setup(ctx) -> state
    window(ctx, state, rec)    # fills rec["end_to_end"], rec["attempted"]
    segment(ctx, state, rec)   # the traced segment (the profiler is on)
    check(ctx, state, rec)     # -> [(name, value, limit)], failed

``rec`` is the run's record, which the per-layer readers read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
# top-level module names that no run may load (the JAX stack and the
# JAX package the port was made from), compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["FORBIDDEN", "forbidden_modules", "Context", "run_cell", "main"]


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are in :data:`FORBIDDEN`."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_file(path: str):
    """Import one harness file by its path (its name may hold dots)."""
    name = "portbench_" + os.path.relpath(path, PB).replace(
        os.sep, "_").replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel-cache directories inside the checkout (the
    port's own libraries build into ``build/repro_torch_kernels``)."""
    base = os.path.join(root, "build", "portbench")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda_cache")}


@dataclasses.dataclass
class Context:
    """What a mode sees of the run."""

    config: dict         # configs/<config>.json
    traffic: dict        # traffic/<mix>.json
    seed: int
    seconds: float
    device: str          # "cuda" on the card; "cpu" only in the tests
    quiet: object = None  # where the program's own prints go


def _metrics_for(bench: dict, cell: str, section: str) -> list:
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


def _reader(pb: str, name: str):
    """The per-layer reader of metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<quantity>.py`` for ``<quantity>.<suffix>``, else the
    generic roofline reader for ``<kernel>_roofline``."""
    for stem in (name, name.split(".")[0]):
        path = os.path.join(pb, "metrics", stem + ".py")
        if os.path.exists(path):
            return load_file(path).read
    if name.endswith("_roofline"):
        kernel = name[:-len("_roofline")]
        if os.path.exists(os.path.join(pb, "rooflines", kernel + ".py")):
            return lambda rec: rec.get("rooflines", {}).get(kernel)
    raise FileNotFoundError(f"no reader for per-layer metric {name!r}")


def _rooflines_wanted(pb: str, metrics: list) -> dict:
    out = {}
    for m in metrics:
        if m["name"].endswith("_roofline"):
            kernel = m["name"][:-len("_roofline")]
            path = os.path.join(pb, "rooflines", kernel + ".py")
            if os.path.exists(path):
                out[kernel] = load_file(path)
    return out


@contextlib.contextmanager
def _patched(pairs, wrap):
    """Replace each ``module.function`` of ``pairs`` by ``wrap(label,
    original)`` inside the block."""
    saved = []
    try:
        for modname, fn in pairs:
            mod = importlib.import_module(modname)
            orig = getattr(mod, fn)
            saved.append((mod, fn, orig))
            setattr(mod, fn, wrap(fn, orig))
        yield
    finally:
        for mod, fn, orig in reversed(saved):
            setattr(mod, fn, orig)


def _span_wrap(label, orig):
    import torch

    def spanned(*a, **k):
        with torch.profiler.record_function(label):
            return orig(*a, **k)
    return spanned


def _traced_segment(ctx: Context, mode, state, rec: dict, roofs: dict):
    """Run the mode's segment under ``torch.profiler`` with the host
    spans and the roofline call counters on; fill ``rec["trace"]`` and
    ``rec["rooflines"]``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import peaks, profiling
    from repro_torch.kernels import ops

    counters = {k: r.Calls() for k, r in roofs.items()}

    def count_wrap(kernel):
        def wrap(label, orig):
            def counted(*a, **k):
                counters[kernel].on_call(*a, **k)
                return orig(*a, **k)
            return counted
        return wrap

    acts = [ProfilerActivity.CPU]
    if ctx.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    launches0 = ops.launch_counts()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(getattr(mode, "SPANS", ()), _span_wrap))
        for kernel, r in roofs.items():
            stack.enter_context(_patched([r.TARGET], count_wrap(kernel)))
        prof = stack.enter_context(profile(activities=acts))
        with torch.profiler.record_function(profiling.WINDOW):
            mode.segment(ctx, state, rec)
            if ctx.device == "cuda":
                torch.cuda.synchronize()
    launched = {k: v - launches0[k] for k, v in ops.launch_counts().items()}
    tr = profiling.read(prof)
    rec["trace"] = tr
    rec["rooflines"] = {}
    for kernel, r in roofs.items():
        if launched.get(kernel, 0) == 0 or any(
                launched.get(o, 0) for o in r.SHARES_KERNELS_WITH):
            continue
        dev_s = sum(s for name, s in tr["kernel_s"].items()
                    if name in r.DEVICE_KERNELS)
        if dev_s <= 0:
            continue
        n_ops, n_bytes = counters[kernel].totals()
        bound = n_bytes / peaks.HBM
        if r.OPS_KIND is not None:
            bound = max(bound, n_ops / peaks.PEAK_OPS[r.OPS_KIND])
        rec["rooflines"][kernel] = 100.0 * bound / dev_s


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, pb: str = PB,
             t0: float = None) -> dict:
    """One run of cell ``workload``; returns the result line (a dict).
    ``device="cpu"`` is for the tests: it runs the port's plain
    versions, skips the look for a card and reads no device number."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"[portbench] unknown workload {workload!r}")
    wl = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    ctx = Context(config=_json(os.path.join(root, cfg_entry["file"])),
                  traffic=_json(os.path.join(pb, "traffic",
                                             wl["traffic"] + ".json")),
                  seed=int(seed), seconds=float(seconds), device=device,
                  quiet=sys.stderr)
    mode = load_file(os.path.join(pb, "modes", ctx.traffic["mode"] + ".py"))
    e2e = _metrics_for(bench, workload, "end_to_end")
    layer = _metrics_for(bench, workload, "per_layer")
    readers = {m["name"]: _reader(pb, m["name"]) for m in layer} if trace \
        else {}

    import torch

    rec: dict = {}
    state = mode.setup(ctx)
    rec["setup_s"] = time.perf_counter() - t0
    _note(f"set-up {rec['setup_s']:.3f} s")
    mode.window(ctx, state, rec)
    _note(f"window {rec['window_s']:.3f} s, {rec['attempted']} done")
    if trace:
        t1 = time.perf_counter()
        _traced_segment(ctx, mode, state, rec, _rooflines_wanted(pb, layer))
        _note(f"traced segment and its reading "
              f"{time.perf_counter() - t1:.3f} s")
    peak = 0
    if device == "cuda":
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    t1 = time.perf_counter()
    checks, failed = mode.check(ctx, state, rec)
    _note(f"check against the reference {time.perf_counter() - t1:.3f} s")

    metrics = {}
    if trace:
        for m in layer:
            v = readers[m["name"]](rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(rec["end_to_end"], setup_s=rec["setup_s"])
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device,
           "count": int(wl["chips"]), "memory_peak_bytes": peak}
    if device == "cuda":
        from . import peaks
        dev["power_limit_w"] = peaks.power_limit_w()
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": int(rec["attempted"]), "failed": int(failed),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = rec["trace"]["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    return out


def _note(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class ForbiddenImport(RuntimeError):
    """A module of the JAX stack or the JAX package was loaded."""

    def __init__(self, names):
        super().__init__("loaded: " + ", ".join(names))
        self.names = names


def _parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="python3 portbench/run.py",
        description="One run of one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv, t0: float) -> int:
    """The command line: check for the cards, run, print the result."""
    args = _parser().parse_args(argv)
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"[portbench] unknown workload {args.workload!r}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"[portbench] forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", t0=t0)
    except ForbiddenImport as e:
        print(f"[portbench] forbidden modules loaded: {e.names}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"[portbench] check {name} = {c['value']} (limit "
              f"{c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
