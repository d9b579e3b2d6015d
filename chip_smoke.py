#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdcommunity_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:
  1. build the band kernels (nvcc, sm_90a) and the native host engine (g++)
     from the checkout's sources, in parallel;
  2. check kernels K1 (band_spmm, D=64 and D=2) and K2 (band_sage) against
     their plain PyTorch versions on the card, on seeded banded graphs of
     2^16 nodes with live mirror lanes (and, for K2, no spill);
  3. time K1, K2, their plain versions and a library yardstick (torch.bmm of
     the widened band against materialised windows) at the main path's
     shapes, 18,432 and 2^20 rows with D=64, each beside its bound;
  4. drive the main path: large-graph greedy dismantling of the 18,222-node
     shuffled synthetic duplex of `large_graph_demo --sizes 18222` by the
     committed unit-cost checkpoint, through eval.real.evaluate_real
     (StepRatio 0.001, one host cascade per batch, native host engine), with
     every kernel's launch count set to 0 just before and read just after;
     its first forward is held against the same forward on the CPU.
Prints the card's name and power limit, a `kernels` JSON line, and as its
last line {"ok": true, "device": {...}}.  Needs one CUDA card; without one it
exits non-zero and prints no result.  --rehearse runs every phase at a small
size on the CPU with the plain versions (no counts, no result line).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
OUT = os.path.join(HERE, "runs", "chip_smoke")
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_S = 67e12       # H100 SXM FP32 outside the tensor cores
REL_TOL = 1e-4           # kernel vs plain: f32 sums in another order


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()


# ---------------------------------------------------------------- build


def build_all():
    from mdcommunity_tpu_torch.native import build as native_build
    from mdcommunity_tpu_torch.ops import band_kernels

    errs, times = {}, {}

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            fn(force=True)
        except Exception as exc:  # re-raised below, after both builds end
            errs[name] = exc
        times[name] = time.perf_counter() - t0

    threads = [
        threading.Thread(target=run, args=("band.cu (nvcc)", band_kernels.build)),
        threading.Thread(target=run, args=("mdc_native.cpp (g++)", native_build.build)),
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, exc in errs.items():
        raise RuntimeError(f"build of {name} failed") from exc
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    with open(os.path.join(os.path.dirname(band_kernels.LIB), "band_ptxas.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())


# ---------------------------------------------------------------- graphs


def synth_banded(n, shuffle, seed, device, reorder=True):
    import numpy as np

    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(seed), shuffle=shuffle)
    banded, _, _ = build_banded_duplex(n, e0, e1, reorder=reorder, max_rank=0,
                                       device=device)
    return banded


def operands(dbg, D, seed, device, unit=False):
    """h [pad_n, D] and live scales (10% of nodes covered), seeded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    live = (torch.rand(dbg.pad_n, generator=g) > 0.1).float()
    live[dbg.n:] = 0
    if unit:  # the degree pass: unit scales, [live, mask] right-hand side
        mask = torch.zeros(dbg.pad_n)
        mask[: dbg.n] = 1
        h = torch.stack([live, mask], -1)
        live = torch.ones(dbg.pad_n)
    else:
        h = torch.randn(dbg.pad_n, D, generator=g)
    return h.to(device).contiguous(), live.to(device)


def sage_weights(device):
    from mdcommunity_tpu_torch.models.checkpoint import load_params

    import torch

    p = load_params(CKPT)
    c1, c2, c3 = (torch.from_numpy(p[k]).to(device) for k in
                  ("p_node_conv", "p_node_conv2", "p_node_conv3"))
    d = c1.shape[0]
    return (c1 @ c3[:d]).contiguous(), (c2 @ c3[d:]).contiguous()


# ---------------------------------------------------------------- checks


def compare(name, got, ref):
    import torch

    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = err / max(scale, 1e-30)
    log(f"check {name}: max_abs_err {err:.3e}  max|ref| {scale:.3e}  rel {rel:.3e}")
    if not torch.isfinite(got).all() or rel > REL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_kernels(device, n):
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    import torch

    errs = {}
    mirrored = synth_banded(n, True, 1, device)
    dbg = mirrored.dbg0
    log(f"check graph A: n={n} C={dbg.C} spill={dbg.spill.nnz}")
    if not dbg.C:
        raise AssertionError("check graph A has no mirror lanes")
    h, live = operands(dbg, 64, 2, device)
    sub = mirror_sub(dbg, live, h)
    errs["band_spmm"] = compare(
        "K1 D=64", bk.spmm_band(dbg, live, live, h, sub),
        bk.spmm_band_plain(dbg, live, live, h, sub))
    h2, ones = operands(dbg, 2, 3, device, unit=True)
    sub2 = mirror_sub(dbg, ones, h2)
    errs["band_spmm"] = max(errs["band_spmm"], compare(
        "K1 D=2", bk.spmm_band(dbg, ones, ones, h2, sub2),
        bk.spmm_band_plain(dbg, ones, ones, h2, sub2)))

    clean = synth_banded(n, False, 1, device)
    dbg = clean.dbg0
    log(f"check graph B: n={n} C={dbg.C} spill={clean.dbg0.spill.nnz}+"
        f"{clean.dbg1.spill.nnz}")
    if not (clean.spill_free and dbg.C):
        raise AssertionError("check graph B needs mirror lanes and no spill")
    h, live = operands(dbg, 64, 4, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    sub = mirror_sub(dbg, live, h)
    aw, bw = sage_weights(device)
    errs["band_sage"] = compare(
        "K2", bk.sage_step(dbg, live, live, h, sub, aw, bw),
        bk.sage_step_plain(dbg, live, live, h, sub, aw, bw))
    return errs


# ---------------------------------------------------------------- timing


def time_ms(fn, reps=20, warm=3):
    """Median ms of `reps` calls after `warm` (CUDA events; the rehearsal on
    the CPU times with the host clock)."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    if not torch.cuda.is_available():
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return sorted(times)[reps // 2]
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bounds(dbg, D, sage):
    """Least time for the function on these inputs: each input read once,
    the output written once, over the card's memory rate; the operations
    this data needs (one multiply-add per band nonzero and column, the
    mirror add, the row scale; K2 also its two D×D products and the
    normalisation) over the FP32 rate.  Returns (ms, bound_by)."""
    nb, S, C, pad_n = dbg.n_blocks, dbg.S, dbg.C, dbg.pad_n
    nnz = int((dbg.base[:, :S] != 0).sum().item())
    byts = (nb * S * dbg.W2 + pad_n * D * 4 * 2 + 2 * pad_n * 4
            + nb * C * D * 4 + nb * S * 4)
    ops = 2 * nnz * D + 2 * pad_n * D
    if sage:
        byts += 2 * D * D * 4
        ops += 2 * 2 * pad_n * D * D + 3 * pad_n * D
    t_b, t_o = byts / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def time_kernels(device, banded, label):
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.band_kernels import _windows
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    import torch

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    sub = mirror_sub(dbg, live, h)
    aw, bw = sage_weights(device)
    base_f = dbg.base.to(torch.float32)
    win = _windows(h * live[:, None], dbg.n_blocks, dbg.S, dbg.B).contiguous()
    lib_ms = time_ms(lambda: torch.bmm(base_f, win))
    del base_f, win
    # the kernels against their plain versions at these shapes too, the
    # degree pass (D = 2, unit scales) included
    errs = {
        "band_spmm": compare(f"{label} K1 D=64", bk.spmm_band(dbg, live, live, h, sub),
                             bk.spmm_band_plain(dbg, live, live, h, sub)),
        "band_sage": compare(f"{label} K2", bk.sage_step(dbg, live, live, h, sub, aw, bw),
                             bk.sage_step_plain(dbg, live, live, h, sub, aw, bw)),
    }
    h2, ones = operands(dbg, 2, 6, device, unit=True)
    sub2 = mirror_sub(dbg, ones, h2)
    errs["band_spmm"] = max(errs["band_spmm"], compare(
        f"{label} K1 D=2", bk.spmm_band(dbg, ones, ones, h2, sub2),
        bk.spmm_band_plain(dbg, ones, ones, h2, sub2)))
    res = {}
    for name, kern, plain, sage in (
        ("band_spmm", lambda: bk.spmm_band(dbg, live, live, h, sub),
         lambda: bk.spmm_band_plain(dbg, live, live, h, sub), False),
        ("band_sage", lambda: bk.sage_step(dbg, live, live, h, sub, aw, bw),
         lambda: bk.sage_step_plain(dbg, live, live, h, sub, aw, bw), True),
    ):
        bound_ms, bound_by = bounds(dbg, 64, sage)
        res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                         max_abs_err=errs[name])
        log(f"time {label} {name}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(res[name]))
    return res


# ---------------------------------------------------------------- main path


def main_path(device, n, step_ratio):
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.eval.real import evaluate_real
    from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy_banded
    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk

    net = load_model(CKPT, device=device)
    # the graph of `large_graph_demo --sizes n`: the generator's first draw
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    os.makedirs(OUT, exist_ok=True)
    name = f"synthetic_{n}_multiplex.edges"
    write_edges(os.path.join(OUT, name), e0, e1)

    # the first forward on the card against the same forward on the CPU
    qs = {}
    for dev in (device, "cpu"):
        banded, _, _ = build_banded_duplex(n, e0, e1, max_rank=0, device=dev)
        covered = ~banded.node_mask
        qs[dev] = banded_test_forward(
            net.to(dev), banded, covered, fuse_sage=banded.spill_free
        ).cpu()
    net = net.to(device)
    q, ref = qs[device], qs["cpu"]
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(q), fin) or not fin.any():
        raise AssertionError("first forward: -inf masks differ")
    qerr = (q[fin] - ref[fin]).abs().max().item()
    log(f"main path first forward vs CPU: max_abs_err {qerr:.3e} "
        f"(max|Q| {ref[fin].abs().max().item():.3e})")
    if qerr > 1e-4 * ref[fin].abs().max().item():
        raise AssertionError("first forward disagrees with the CPU forward")

    stats = {}
    bk.reset_launches()
    t0 = time.perf_counter()
    sol, solve_s, score = evaluate_real(
        net, OUT, name, os.path.join(OUT, "results"), n_nodes=n, layers=(1, 2),
        step_ratio=step_ratio, batch_env=True, blocked_threshold=0,
        device=device, engine="native",
        stats=stats,
    )
    if device != "cpu":
        torch.cuda.synchronize()
    counts = dict(bk.launches)
    mean_fwd = 1e3 * stats["model_call_s"] / max(stats["model_calls"], 1)
    log("main path: " + json.dumps(dict(
        n=n, step_ratio=step_ratio, audc=score, removed=len(sol),
        solve_s=solve_s, wall_s=time.perf_counter() - t0,
        model_calls=stats["model_calls"], mean_model_call_ms=mean_fwd,
        fuse_sage=stats["fuse_sage"], host_env=stats["host_env"],
        spill=stats["spill"], mirror_C=stats["mirror_C"], launches=counts)))
    if stats["host_env"] != "native":
        raise AssertionError("the main path must run the native host engine")
    if not (0.0 < score < 1.0) or not sol or len(set(sol)) != len(sol):
        raise AssertionError("main path result out of range")
    if not all(0 <= v < n for v in sol):
        raise AssertionError("solution ids out of range")
    tag = os.path.join(OUT, "results", f"StepRatio_{step_ratio:.4f}")
    with open(os.path.join(tag, f"NormalizedLMCC_synthetic_{n}_multiplex_12.txt")) as f:
        lines = f.read().split()
    if len(lines) != n + 2 or abs(float(lines[-2]) - score) > 1e-8:
        raise AssertionError("NormalizedLMCC file malformed")

    if not stats["fuse_sage"]:
        # the shuffled build has spill, so K2 did not run: a short run on the
        # generator's own (well-banded, spill-free) order drives it
        e0u, e1u = synth_duplex_edges(n, 6, np.random.default_rng(0), shuffle=False)
        banded, _, (o0, o1) = build_banded_duplex(n, e0u, e1u, device=device)
        if not banded.spill_free:
            raise AssertionError("the unshuffled build has spill")
        env = make_host_env(n, o0, o1, engine="native")
        bk.reset_launches()
        sol2, score2, _ = dismantle_greedy_banded(
            net, banded, env, step=max(int(step_ratio * n), 1), batch_env=True,
            max_steps=n // 10)
        more = dict(bk.launches)
        log("main path, unshuffled phase: " + json.dumps(dict(
            removed=len(sol2), score=score2, launches=more)))
        counts = {k: counts[k] + more[k] for k in counts}
    return counts, dict(audc=score, removed=len(sol))


# ---------------------------------------------------------------- driver


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="every phase at a small size on the CPU (plain "
                         "versions); prints no result line")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "mdcommunity_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.utils.device import set_precise_matmul

    set_precise_matmul()
    if args.rehearse:
        from mdcommunity_tpu_torch.native import build as native_build

        native_build.build()
        check_kernels("cpu", 2048)
        time_kernels("cpu", synth_banded(2048, True, 0, "cpu"), "rehearsal")
        main_path("cpu", 2048, 0.01)
        log("rehearsal done")
        return 0
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs one GPU")
    device = "cuda"
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()
    errs = check_kernels(device, 1 << 16)

    main_graph = synth_banded(18222, True, 0, device)
    times = time_kernels(device, main_graph, "18,432 rows")
    del main_graph
    big = synth_banded(1 << 20, False, 0, device, reorder=False)
    time_kernels(device, big, "2^20 rows")
    del big
    torch.cuda.empty_cache()

    counts, result = main_path(device, 18222, 0.001)
    for k, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"main path AUDC {result['audc']:.6f} after {result['removed']} removals")

    kernels = []
    for name in ("band_spmm", "band_sage"):
        t = dict(times[name])
        t["max_abs_err"] = max(errs[name], t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/band.cu",
            replaces="mdcommunity_tpu/ops/band_pallas.py:259",
            launches=counts[name], **t))
    log(gpu_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
