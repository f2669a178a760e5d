"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs as many CUDA cards as the cell asks
for, and exits non-zero without a result otherwise.  The last line of
standard output is one JSON object (`correct`, `attempted`, `failed`,
`metrics`, `device`, with --trace 1 `breakdown`, and last `checks`, each
compared number beside its limit); the same checks end standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def cache_dirs(root):
    """Fixed build and kernel-cache directories inside the checkout, so that
    only the first run of a checkout builds."""
    cache = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    # libraries the program may import must not load JAX or TensorFlow
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    cache_dirs(str(harness.ROOT))
    import torch

    spec = harness.spec()
    cell = harness.cell(args.workload, spec)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.make_context(args.workload, args.seed, args.seconds, args.trace)
    ctx.t_start = T_START
    harness.note(ctx, "imported")
    record = harness.module("drivers", ctx.traffic["driver"]).run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    out = harness.result(ctx, record, spec)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
