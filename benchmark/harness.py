"""What every cell shares: finding its pieces by name, the program's config
as the configuration file states it, the reading of a profiler trace, the
checks that decide `correct`, and the result line.

A cell of BENCHMARK.json names a configuration (`configs/<name>.json`) and
a traffic mix (`traffic/<name>.json`, whose `driver` names the module of
`drivers/` that runs it); its limits are `limits/<cell>.json`; a per-layer
metric is read by `metrics/<metric>.py`'s `read(record)` (or, for `<base>.<part>`
without a file of its own, by `metrics/<base>.py`'s).  A configuration's
`family` names `families/<family>.py` (operation counts, conditioning, the
plain reference), its dataset `datasets/<dataset>.py`.
"""
from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import math
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "panopticdiffusionmodels_tpu")


def load_json(*parts):
    with open(BENCH.joinpath(*parts[:-1], parts[-1] + ".json")) as f:
        return json.load(f)


def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell(name, benchmark=None):
    benchmark = benchmark or spec()
    for w in benchmark["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def module(kind, name):
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name):
    """`metrics/<name>.py`'s `read`; a metric `<base>.<part>` without a file
    of its own takes `metrics/<base>.py`'s (one reader for a quantity split
    by the end-to-end metric it moves)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    loaded = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def _merge(base, over):
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _differences(port, stated, prefix=""):
    out = []
    for k, v in stated.items():
        got = port.get(k)
        if isinstance(v, dict) and isinstance(got, dict):
            out += _differences(got, v, f"{prefix}{k}.")
        elif json.loads(json.dumps(got)) != v:
            out.append(f"{prefix}{k}: program {got!r}, file {v!r}")
    return out


def port_config(cfg, shrink=None):
    """The program's config of the file's `port_config`, with the file's
    `reduced` groups applied; every other key the file states must be the
    program's own (the file holds the configuration as it is run).  `shrink`
    (CPU tests only) overrides sizes on top."""
    from panopticdiffusionmodels_torch.configs import get_config
    from panopticdiffusionmodels_torch.configs.base import ConfigDict

    config = get_config(cfg["port_config"])
    stated = cfg["config"]
    bad = _differences(config, {k: v for k, v in stated.items() if k not in cfg["reduced"]})
    if bad:
        raise ValueError(f"{cfg['name']}: the program's config differs from the file: {bad}")
    merged = _merge(json.loads(json.dumps(config)), {k: stated[k] for k in cfg["reduced"]})
    if shrink:
        merged = _merge(merged, shrink.get("config", {}))

    def wrap(v):
        return ConfigDict({k: wrap(x) for k, x in v.items()}) if isinstance(v, dict) else v

    out = wrap(merged)
    out.sample.cfg_interval = tuple(out.sample.cfg_interval)
    out.z_shape = tuple(out.z_shape)
    return out


@dataclass
class Context:
    cell: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    shrink: Optional[dict] = None
    t_start: float = 0.0
    checks: list = field(default_factory=list)
    details: dict = field(default_factory=dict)

    @property
    def geometry(self):
        return (self.shrink or {}).get("vae_geometry", self.cfg["vae_geometry"])

    def check(self, name, value, limit=None):
        """Record one compared number against its limit (a value <= limit
        passes; NaN fails)."""
        limit = self.limits[name] if limit is None else limit
        self.checks.append((name, float(value), float(limit)))

    @property
    def correct(self):
        return bool(self.checks) and all(math.isfinite(v) and v <= lim
                                         for _, v, lim in self.checks)


def note(ctx, what):
    """A progress line on standard error: seconds since the run started."""
    import time

    print(f"[bench] {time.perf_counter() - ctx.t_start:.2f} s: {what}", file=sys.stderr,
          flush=True)


def make_context(cell_name, seed, seconds, trace, device="cuda", shrink=None):
    w = cell(cell_name)
    return Context(cell=cell_name, cfg=load_json("configs", w["config"]),
                   traffic=load_json("traffic", w["traffic"]),
                   limits=load_json("limits", cell_name), seed=int(seed),
                   seconds=float(seconds), trace=bool(trace), device=device, shrink=shrink)


# --- the profiler's trace --------------------------------------------------

def trace_events(prof):
    """(device intervals [(start_ns, end_ns, name)], host intervals) of a
    finished torch.profiler run; ranges that annotations draw on the device
    timeline are no device work and are left out."""
    import torch

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start = e.start_ns()
        item = (start, start + e.duration_ns(), e.name())
        (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
    return dev, host


class Profiler:
    """torch.profiler over a slice of a run, recording device activity and
    the CUDA runtime's calls only (recording every host op doubles a
    request's host time).  The traced window runs from `start` to `stop`,
    each of which waits for the device, without the profiler's own start
    and stop."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CUDA] if device == "cuda"
                            else [ProfilerActivity.CPU])

    def _sync(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def start(self):
        import time

        self.prof.start()
        self._sync()
        self.t0 = time.perf_counter()

    def stop(self):
        """The trace's summary (`summarize_trace`)."""
        import time

        self._sync()
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        return summarize_trace(self.prof, wall)


def profiled(fn, device):
    """Run fn() (which ends with the device synchronised) under `Profiler`;
    returns the trace's summary."""
    p = Profiler(device)
    p.start()
    fn()
    return p.stop()


def summarize_trace(prof, wall_s, top=10):
    """Busy seconds (the union of device intervals), device seconds by name,
    the heaviest device operations and the longest idle gaps, each labelled
    with the shortest host call (a CUDA runtime call) under its middle, or
    'no host call' where the host ran Python between calls."""
    dev, host = trace_events(prof)
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    start = min([s for s, _, _ in host] + [s for s, _ in merged]) if (host or merged) else 0
    gaps, prev = [], start
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    labelled = []
    for length, s, e in sorted(gaps, reverse=True)[:top]:
        mid = (s + e) // 2
        under = [(b - a, n) for a, b, n in host if a <= mid <= b]
        labelled.append([f"host: {min(under)[1] if under else 'no host call'}"[:120],
                         length * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": wall_s, "device_s": by_name,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": labelled}}


# --- the result ------------------------------------------------------------

def device_info(ctx, peak_bytes, trace=None, count=1):
    import torch

    info = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
            "kind": torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu",
            "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return info


def result(ctx, record, benchmark=None):
    """The result line's object: the cell's end-to-end metrics (--trace 0)
    or per-layer metrics (--trace 1), the device, the breakdown, the checks."""
    benchmark = benchmark or spec()
    metrics = {}
    if ctx.trace:
        for m in benchmark["per_layer"]:
            if applies(m, ctx.cell):
                value = metric_reader(m["name"])(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in benchmark["end_to_end"]:
            if applies(m, ctx.cell):
                metrics[m["name"]] = {"value": record["end_to_end"][m["name"]], "unit": m["unit"]}
    out = {"correct": ctx.correct, "attempted": record["attempted"], "failed": record["failed"],
           "metrics": metrics,
           "device": device_info(ctx, record["peak_bytes"], record.get("trace") if ctx.trace
                                 else None, record.get("devices", 1))}
    if ctx.trace and record.get("trace"):
        out["breakdown"] = record["trace"]["breakdown"]
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in ctx.checks}
    return out
