"""Run one cell of the benchmark once.

    python3 -m mdbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (mdcommunity_tpu_torch)
and a CUDA card.  Set-up (imports, the nvcc and g++ libraries on a
checkout's first run, the graph from --seed, the band build, the host env,
the checkpoint, one warm forward) is timed as setup_s; then the window runs
the program's own loop for --seconds; then the plain reference judges what
the window produced.  The last line of standard output is the result as
one JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key (before them: set-up's
phases, and in a train cell each leaf's gradient and update gaps).  --trace 1 profiles a
bounded stretch of the window and reports the per-layer metrics instead of
the end-to-end ones.  It exits non-zero, printing no result, without the
card or the program, or if JAX or the JAX package was loaded.

--rehearse N runs the cell on the CPU at N nodes, with the kernels' plain
versions (a test of the harness, not a measurement).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def _caches(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's own nvcc and g++ libraries go to its _build/)."""
    base = os.path.join(root, ".mdbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)


def _fail(code: int, msg: str) -> int:
    print(f"mdbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    root = os.getcwd()
    _caches(root)

    from mdbench.manifest import Manifest

    try:
        man = Manifest.load(root)
        cell = man.cell(args.workload)
        config = man.config(cell["config"])
        traffic = man.traffic(cell["traffic"])
        limits = man.limits(cell["name"])
    except (OSError, KeyError, ValueError) as e:
        return _fail(2, f"cannot read the cell: {e}")
    if importlib.util.find_spec("mdcommunity_tpu_torch") is None:
        return _fail(2, "the program (mdcommunity_tpu_torch) is not in this checkout")

    import torch

    from mdbench.common import Ctx, no_jax_modules

    if args.rehearse:
        device, n = torch.device("cpu"), int(args.rehearse)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            return _fail(3, f"the cell needs {cell['chips']} CUDA card(s); "
                            f"{torch.cuda.device_count()} visible")
        device, n = torch.device("cuda", 0), int(traffic["n"])
    ctx = Ctx(root=root, cell=cell, config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device, n=n,
              t_process=T_PROCESS, limits=limits)
    man.kind(traffic).run(ctx)

    found = no_jax_modules()
    if found:
        return _fail(4, f"JAX or the JAX package was loaded: {', '.join(found)}")

    metrics = {}
    if args.trace:
        for m in man.per_layer(cell["name"]):
            v = man.reader(m["name"])(ctx.layer)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in man.end_to_end(cell["name"]):
            metrics[m["name"]] = {"value": float(ctx.e2e[m["name"]]), "unit": m["unit"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(ctx.memory_peak_bytes)}
    if args.trace and ctx.busy_s is not None:
        dev.update(busy_s=ctx.busy_s, window_s=ctx.window_s)
    result = {"correct": ctx.correct, "attempted": ctx.attempted, "failed": ctx.failed,
              "metrics": metrics, "device": dev}
    if ctx.breakdown is not None:
        result["breakdown"] = ctx.breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in ctx.checks}
    sys.stdout.flush()
    if "leaves" in ctx.layer:
        print("leaves: " + json.dumps(ctx.layer["leaves"]), file=sys.stderr)
    print("phases: " + ", ".join(f"{name} {sec:.1f} s" for name, sec, _ in ctx.phases)
          + "".join(f", trace read {sec:.1f} s" for sec in ctx.layer.get("trace_read_s", [])),
          file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
