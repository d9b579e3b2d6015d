#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdcommunity_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:
  1. build the band kernels (nvcc, sm_90a) and the native host engine (g++)
     from the checkout's sources, in parallel;
  2. check kernels K1 (band_spmm, D=64 and D=2) and K2 (band_sage) against
     their plain PyTorch versions on the card, on seeded banded graphs of
     2^16 nodes with live mirror lanes (and, for K2, no spill), and K1's
     backward (band_spmm_bwd: torch.autograd.grad through BandSpmm, row !=
     col) against autograd through the plain operator;
  3. time K1, K2, K1's backward, their plain versions and a library
     yardstick (torch.bmm of the widened band against materialised windows)
     at the main path's shapes, 18,432 and 2^20 rows with D=64, each beside
     its bound;
  4. drive the main path: large-graph greedy dismantling of the 18,222-node
     shuffled synthetic duplex of `large_graph_demo --sizes 18222` by the
     committed unit-cost checkpoint, through eval.real.evaluate_real
     (StepRatio 0.001, one host cascade per batch, native host engine), with
     every kernel's launch count set to 0 just before and read just after;
     its first forward is held against the same forward on the CPU;
  5. hold one fit's loss and parameter gradients on the card to the CPU's
     (18,222 nodes, the fine-tuning checkpoint, 1,048 actions);
  6. drive the training path: 6 iterations of rl.big_trainer's loop at k =
     1,048 on a spill-free 2^20-node build (selection runs K2, every fit's
     gradient K1 with swapped scales), counts set to 0 just before and read
     just after, and one fit's peak memory with and without remat.
Prints the card's name and power limit, a `kernels` JSON line, and as its
last line {"ok": true, "device": {...}}.  Needs one CUDA card; without one it
exits non-zero and prints no result.  --rehearse runs every phase at a small
size on the CPU with the plain versions (no counts, no result line).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(HERE, "models_tpu", "unit_cost_full_r1", "best_model.ckpt")
# the checkpoint train_1m fine-tunes
CKPT_FIT = os.path.join(HERE, "models_tpu", "unit_cost_full_r4", "best_model.ckpt")
OUT = os.path.join(HERE, "runs", "chip_smoke")
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
PEAK_F32_S = 67e12       # H100 SXM FP32 outside the tensor cores
REL_TOL = 1e-4           # kernel vs plain: f32 sums in another order
TIE = 1e-5               # of max|Q|: a gap no f32 forward of this depth resolves
BLOCKED_STEPS = 720      # removals of the blocked path's run (step 18): about a minute
GOLDEN_VC = 0.1194451824  # tests/test_golden_models.py, unit cost, 32 graphs
GOLDEN_SYN = os.path.join(HERE, "results_tpu", "golden_synthetic", "golden.json")


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
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels

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
        threading.Thread(target=run, args=("blocked.cu (nvcc)", blocked_kernels.build)),
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
    for name in ("band", "blocked"):
        with open(os.path.join(os.path.dirname(band_kernels.LIB), f"{name}_ptxas.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}:", line.strip())


# ---------------------------------------------------------------- graphs


def synth_banded(n, shuffle, seed, device, reorder=True, with_edges=False):
    """A large_graph_demo graph's banded build; with_edges=True also returns
    its ordered edge lists (for a host env)."""
    import numpy as np

    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(seed), shuffle=shuffle)
    banded, _, edges = build_banded_duplex(n, e0, e1, reorder=reorder, max_rank=0,
                                           device=device)
    return (banded, edges) if with_edges else banded


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
    # the backward: K1 with the scales swapped, on a cotangent g, row != col
    row, col = scales(dbg, 9, device)
    g = torch.nn.functional.normalize(operands(dbg, 64, 10, device)[0], dim=-1)
    sub_g = mirror_sub(dbg, row, g)
    errs["band_spmm_bwd"] = compare(
        f"{label} K1 backward", bk.spmm_band(dbg, col, row, g, sub_g, "band_spmm_bwd"),
        bk.spmm_band_plain(dbg, col, row, g, sub_g))
    base_f = dbg.base.to(torch.float32)
    win = _windows(g * row[:, None], dbg.n_blocks, dbg.S, dbg.B).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.bmm(base_f, win))
    del base_f, win
    res = {}
    for name, kern, plain, sage, lib in (
        ("band_spmm", lambda: bk.spmm_band(dbg, live, live, h, sub),
         lambda: bk.spmm_band_plain(dbg, live, live, h, sub), False, lib_ms),
        ("band_sage", lambda: bk.sage_step(dbg, live, live, h, sub, aw, bw),
         lambda: bk.sage_step_plain(dbg, live, live, h, sub, aw, bw), True, lib_ms),
        ("band_spmm_bwd", lambda: bk.spmm_band(dbg, col, row, g, sub_g, "band_spmm_bwd"),
         lambda: bk.spmm_band_plain(dbg, col, row, g, sub_g), False, lib_bwd_ms),
    ):
        bound_ms, bound_by = bounds(dbg, 64, sage)
        res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                         max_abs_err=errs[name])
        log(f"time {label} {name}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(res[name]))
    return res


# ---------------------------------------------------------------- K1 backward


def scales(dbg, seed, device):
    """Different row and col scales, seeded: live·u and live·v with u, v
    uniform in [0.5, 1.5) (a backward that forgot to swap them disagrees)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    live = (torch.rand(dbg.pad_n, generator=g) > 0.1).float()
    live[dbg.n:] = 0
    row = live * (0.5 + torch.rand(dbg.pad_n, generator=g))
    col = live * (0.5 + torch.rand(dbg.pad_n, generator=g))
    return row.to(device), col.to(device)


def plain_operator(dbg, row, col, h):
    """The full band operator from plain PyTorch operations only (K1's plain
    version, the mirror gather, the spill segment sum), so that autograd
    derives its gradient independently of BandSpmm."""
    from mdcommunity_tpu_torch.ops.band_kernels import spmm_band_plain
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub
    from mdcommunity_tpu_torch.ops.spmm_csr import spmm_sorted

    out = spmm_band_plain(dbg, row, col, h, mirror_sub(dbg, col, h))
    if dbg.spill.nnz:
        out = out + spmm_sorted(dbg.spill, dbg.w_spill, h * col[:, None]) * row[:, None]
    return out


def check_backward(device, n):
    """torch.autograd.grad through BandSpmm (K1, and K1 with the scales
    swapped for the gradient) against autograd through the plain operator."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band_grad

    dbg = synth_banded(n, True, 1, device).dbg0
    log(f"check backward graph: n={n} C={dbg.C} spill={dbg.spill.nnz}")
    row, col = scales(dbg, 7, device)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(dbg.pad_n, 64, generator=gen).to(device).requires_grad_()
    g = torch.randn(dbg.pad_n, 64, generator=gen).to(device)
    (got,) = torch.autograd.grad(spmm_dense_band_grad(dbg, row, col, h), h, g)
    (ref,) = torch.autograd.grad(plain_operator(dbg, row, col, h), h, g)
    return compare("K1 backward D=64, row != col, autograd", got, ref)


# ---------------------------------------------------------------- the fit


def check_fit(device, n):
    """One fit's loss and parameter gradients on `device` against the CPU
    (plain versions), on the main path's graph with the fine-tuning
    checkpoint, the top 1,048 actions of its first forward and seeded
    targets.  Each leaf is held to the CPU's f64 gradient, within 1e-4 of
    the leaf's max |grad| or four times the CPU's own f32 error on it,
    whichever is larger: the gate's gradients (w_layer1, w_layer2) are
    differences of the two layers' near-equal halves, below what f32
    resolves (~1% of their value on this graph, in either engine)."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward, banded_train_loss

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    builds = {d: build_banded_duplex(n, e0, e1, max_rank=0, device=d)[0]
              for d in (device, "cpu")}
    k = min(1048, n // 4)
    tgts = torch.from_numpy(
        (0.05 * np.random.default_rng(1).standard_normal(k) + 0.03).astype(np.float32))
    acts, res = None, []
    for d, dt in ((device, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        banded = builds[d]
        net = load_model(CKPT_FIT, device=d).to(dt)
        covered = ~banded.node_mask
        if acts is None:
            acts = top_k_stable(banded_test_forward(net, banded, covered), k)[1]
        net.requires_grad_()
        loss = banded_train_loss(net, banded, covered, torch.from_numpy(acts).to(d),
                                 tgts.to(d, dt))
        loss.backward()
        res.append((loss.item(), {name: p.grad.detach().double().cpu()
                                  for name, p in net.named_parameters()}))
    (l_dev, g_dev), (l_32, g_32), (l_64, g_64) = res
    log(f"fit check: loss {l_dev:.9e} on {device}, {l_32:.9e} CPU f32, "
        f"{l_64:.9e} CPU f64")
    if abs(l_dev - l_64) > 1e-5 * abs(l_64):
        raise AssertionError("fit loss differs from the CPU's")
    worst = 0.0
    for name, ref in g_64.items():
        scale = ref.abs().max().item()
        err = (g_dev[name] - ref).abs().max().item()
        cpu_err = (g_32[name] - ref).abs().max().item()
        tol = max(1e-4 * scale, 4 * cpu_err)
        log(f"  grad {name}: max|g| {scale:.3e}  {device} err {err:.3e}  "
            f"CPU f32 err {cpu_err:.3e}  tol {tol:.3e}")
        if not scale > 0 or err > tol:
            raise AssertionError(f"fit gradient of {name} differs from the CPU's")
        worst = max(worst, err / scale)
    return worst


def trainer_phase(device, banded, edges, k):
    """train_banded_loop for 6 iterations (target_update 3) on a spill-free
    build, so selection runs K2 and every fit's gradient runs K1 with
    swapped scales; launch counts set to 0 just before, read just after."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop

    if not banded.spill_free:
        raise AssertionError("the trainer phase needs a spill-free build")
    net = load_model(CKPT_FIT, device=device)
    env = make_host_env(banded.n_nodes, *edges, engine="native")
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    bk.reset_launches()
    t0 = time.perf_counter()
    net2, hist = train_banded_loop(net, banded, env, iters=6, k=k, target_update=3,
                                   log=log, log_every=1)
    if on_card:
        torch.cuda.synchronize()
    counts = dict(bk.launches)
    wall = time.perf_counter() - t0
    rows = [h for h in hist if "loss" in h]
    for h in rows:
        log("trainer iteration: " + json.dumps(h))
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    log("trainer phase: " + json.dumps(dict(
        pad_n=banded.pad_n, k=k, wall_s=wall, peak_mem_gib=peak, launches=counts)))
    fitted = [h["loss"] for h in rows if h["removed"] == k]
    if not fitted or not np.isfinite(fitted).all():
        raise AssertionError("a full batch was not fitted to a finite loss")
    moved = sum((a - b.detach()).abs().sum().item()
                for a, b in zip(net.parameters(), net2.parameters()))
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    if env.t != sum(h["removed"] for h in rows):
        raise AssertionError("env.t differs from the removals the loop counted")
    for name, c in counts.items():
        if on_card and c <= 0:
            raise AssertionError(f"kernel {name} was not launched in the trainer phase")
    return counts


def fit_memory(device, banded, k):
    """Peak device memory and time of one fit (loss + backward) with and
    without remat, on a pristine build."""
    import torch

    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_train_loss

    net = load_model(CKPT_FIT, device=device).requires_grad_()
    gen = torch.Generator().manual_seed(11)
    acts = torch.randperm(banded.n_nodes, generator=gen)[:k].to(device)
    tgts = (0.05 * torch.randn(k, generator=gen) + 0.03).to(device)
    covered = ~banded.node_mask
    for remat in (True, False):
        net.zero_grad(set_to_none=True)
        if device == "cpu":
            banded_train_loss(net, banded, covered, acts, tgts, remat=remat).backward()
            log(f"fit memory, remat={remat}: not measured (CPU)")
            continue
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        banded_train_loss(net, banded, covered, acts, tgts, remat=remat).backward()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        log("fit memory: " + json.dumps(dict(
            pad_n=banded.pad_n, k=k, remat=remat, fit_ms=ms,
            peak_gib=peak / 2**30, above_resident_gib=(peak - base) / 2**30,
            resident_gib=base / 2**30)))


# ---------------------------------------------------------------- K4, K5


def random_blocked(device):
    """A random blocked layout (S = T = 512, 2,048 rows) whose destination
    block 1 has no pairs and whose pair count is padded past the real
    pairs, with weights on its real slots."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.ops.blocked_kernels import build_block_coo

    rng = np.random.default_rng(12)
    src, dst = rng.integers(0, 2048, 6000), rng.integers(0, 2048, 6000)
    keep = dst // 512 != 1
    bcoo, _, _, mask = build_block_coo(src[keep], dst[keep], 2048, 512, 512,
                                       device=device)
    if not (int(bcoo.rowptr[2]) == int(bcoo.rowptr[1])
            and int(bcoo.rowptr[-1]) < bcoo.n_pairs):
        raise AssertionError("the random layout needs an empty block and padded pairs")
    w = torch.from_numpy((rng.random(mask.size) * mask).astype(np.float32))
    return bcoo, w.reshape(bcoo.n_pairs, bcoo.T).to(device)


def check_blocked(device):
    """K4 and K5 against their plain versions on the random layout, at
    D = 64 and D = 48."""
    import torch

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk

    bcoo, w = random_blocked(device)
    gen = torch.Generator().manual_seed(13)
    errs = {"spmm_block": 0.0, "sddmm_block": 0.0}
    for D in (64, 48):
        h = torch.randn(bcoo.n_rows, D, generator=gen).to(device)
        g = torch.randn(bcoo.n_rows, D, generator=gen).to(device)
        out = bk.spmm_block(bcoo, w, h)
        if out[512:1024].abs().max().item() != 0:
            raise AssertionError("K4 wrote into the empty destination block")
        errs["spmm_block"] = max(errs["spmm_block"], compare(
            f"K4 random layout D={D}", out, bk.spmm_block_plain(bcoo, w, h)))
        errs["sddmm_block"] = max(errs["sddmm_block"], compare(
            f"K5 random layout D={D} (every slot)", bk.sddmm_block(bcoo, h, g),
            bk.sddmm_block_plain(bcoo, h, g)))
    return errs


def blocked_graph(n, device, max_rank=None):
    """The RCM-ordered blocked build (S = T = 512) of the large_graph_demo
    graph of n nodes (its generator's first draw, shuffled ids)."""
    import numpy as np

    from mdcommunity_tpu_torch.graphs.blocked import build_blocked_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    return build_blocked_duplex(n, e0, e1, S=512, T=512, max_rank=max_rank,
                                device=device)


def blocked_operands(bd, seed, device):
    """Layer 0's layout, its live weights in slot order (10% of nodes
    covered, seeded) and an h [n_rows, 64]: the shapes of a model call."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    bcoo = bd.bcoo[0]
    live = (torch.rand(bd.pad_n, generator=gen) > 0.1).to(device) & bd.g.node_mask
    g = bd.g
    w = (g.edge_mask[0] & live[g.src[0]] & live[g.dst[0]]).float()
    w = w[: bcoo.n_slots].reshape(bcoo.n_pairs, bcoo.T).contiguous()
    h = torch.nn.functional.normalize(torch.randn(bd.pad_n, 64, generator=gen), dim=-1)
    return bcoo, w, h.to(device)


def blocked_bounds(bcoo, w, D, kernel):
    """Least time on these inputs: K4 reads the row ranges, then for each
    real slot (padding it never visits) its slot id, local source and
    weight, h once, writes the output once, and does one multiply-add per
    live edge and column; K5 reads the index arrays over all P·T slots, h
    and g once, writes P·T results, and does one multiply-add per slot and
    column.  Returns (ms, bound_by)."""
    slots, rows = bcoo.n_slots, bcoo.n_rows
    if kernel == "sddmm_block":
        byts = slots * 8 + 2 * rows * D * 4 + slots * 4
        ops = 2 * slots * D
    else:
        byts = bcoo.row_slot.numel() * 12 + (rows + 1) * 4 + 2 * rows * D * 4
        ops = 2 * int((w != 0).sum().item()) * D
    t_b, t_o = byts / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def time_blocked(device, bd, label):
    """K4, K4 as the backward (on a gradient g), K5: each against its plain
    version at these shapes, then timed beside its bound and its library
    yardstick (torch.sparse.mm on a CSR of the same weights for K4,
    torch.sparse.sampled_addmm on the real slots' pattern for K5)."""
    import torch

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk

    bcoo, w, h = blocked_operands(bd, 14, device)
    g = torch.nn.functional.normalize(torch.randn_like(h), dim=-1)
    n_real = int(bcoo.rowptr[-1])
    src, dst = bk._rows(bcoo, n_real)
    wr = w[:n_real].reshape(-1)
    real = torch.zeros(n_real * bcoo.T, dtype=torch.bool, device=h.device)
    real[bcoo.row_slot.long()] = True
    R = bcoo.n_rows
    a_csr = torch.sparse_coo_tensor(torch.stack([dst[real], src[real]]), wr[real],
                                    (R, R), check_invariants=True).coalesce().to_sparse_csr()
    pattern = torch.sparse_coo_tensor(torch.stack([src[real], dst[real]]),
                                      torch.zeros(int(real.sum()), device=h.device),
                                      (R, R), check_invariants=True).coalesce().to_sparse_csr()
    g_t = g.t().contiguous()
    errs = {
        "spmm_block": compare(f"{label} K4", bk.spmm_block(bcoo, w, h),
                              bk.spmm_block_plain(bcoo, w, h)),
        "spmm_block_bwd": compare(f"{label} K4 backward",
                                  bk.spmm_block(bcoo, w, g, "spmm_block_bwd"),
                                  bk.spmm_block_plain(bcoo, w, g)),
        "sddmm_block": compare(f"{label} K5", bk.sddmm_block(bcoo, h, g),
                               bk.sddmm_block_plain(bcoo, h, g)),
    }
    res = {}
    for name, kern, plain, lib in (
        ("spmm_block", lambda: bk.spmm_block(bcoo, w, h),
         lambda: bk.spmm_block_plain(bcoo, w, h), lambda: torch.sparse.mm(a_csr, h)),
        ("spmm_block_bwd", lambda: bk.spmm_block(bcoo, w, g, "spmm_block_bwd"),
         lambda: bk.spmm_block_plain(bcoo, w, g), lambda: torch.sparse.mm(a_csr, g)),
        ("sddmm_block", lambda: bk.sddmm_block(bcoo, h, g),
         lambda: bk.sddmm_block_plain(bcoo, h, g),
         lambda: torch.sparse.sampled_addmm(pattern, h, g_t)),
    ):
        bound_ms, bound_by = blocked_bounds(bcoo, w, 64, name)
        res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=time_ms(lib),
                         max_abs_err=errs[name])
        log(f"time {label} {name}: n_rows={R} P={bcoo.n_pairs} slots={bcoo.n_slots} "
            f"live={int((w != 0).sum().item())} " + json.dumps(res[name]))
    return res


def check_blocked_backward(device, bd):
    """torch.autograd.grad through BlockSpmm (K4, then K4 on the gradient
    and K5) against autograd through the plain operator, on the symmetric
    main-path layout: dh, and dw on every slot (padded pairs, which the
    plain forward never reads, against K5's plain version)."""
    import torch

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk

    bcoo, w, h = blocked_operands(bd, 15, device)
    gen = torch.Generator().manual_seed(16)
    G = torch.randn(h.shape, generator=gen).to(device)
    grads = []
    for fn in (bk.blocked_spmm, bk.spmm_block_plain):
        wv, hv = w.clone().requires_grad_(), h.clone().requires_grad_()
        grads.append(torch.autograd.grad(torch.sum(fn(bcoo, wv, hv) * G), (wv, hv)))
    (dw, dh), (dw_ref, dh_ref) = grads
    n_real = int(bcoo.rowptr[-1])
    err = compare("BlockSpmm backward dh, autograd", dh, dh_ref)
    err = max(err, compare("BlockSpmm backward dw (real pairs, padding slots too)",
                           dw[:n_real], dw_ref[:n_real]))
    err = max(err, compare("BlockSpmm backward dw (padded pairs)", dw[n_real:],
                           bk.sddmm_block_plain(bcoo, h, G)[n_real:]))
    return err


# ---------------------------------------------------------------- small graphs


def reset_all_launches():
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels

    band_kernels.reset_launches()
    blocked_kernels.reset_launches()


def all_launches():
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels

    return {**band_kernels.launches, **blocked_kernels.launches}


def small_graph_phase(device, n_valid=32, sizes=(32, 64, 128), n_graphs=5):
    """The small-graph main path: the validation VC of the unit-cost
    checkpoint on the seed-0 pool (on the card and on the CPU) and the
    golden synthetic sweep's model rows, with the counts set to 0 just
    before and read just after (the dense engine runs no hand kernel)."""
    import dataclasses

    from mdcommunity_tpu_torch.eval.synthetic import evaluate_synthetic_generated
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.rl.dqn import make_valid_pool, validate
    from mdcommunity_tpu_torch.utils.config import Config

    import torch

    cfg = dataclasses.replace(Config(variant="unit_cost"), n_valid=n_valid)
    vcs = {}
    for dev in (device, "cpu"):
        net = load_model(CKPT, device=dev)
        pool = make_valid_pool(cfg, device=dev)
        reset_all_launches()
        t0 = time.perf_counter()
        vcs[dev] = validate(net, pool)
        if dev != "cpu":
            torch.cuda.synchronize()
        log(f"validation VC on {dev}: {vcs[dev]:.10f} ({len(pool)} graphs, "
            f"{time.perf_counter() - t0:.2f} s, launches {json.dumps(all_launches())})")
    log(f"validation VC: {device} {vcs[device]:.10f}, CPU {vcs['cpu']:.10f}, golden "
        f"{GOLDEN_VC}, |{device} - CPU| {abs(vcs[device] - vcs['cpu']):.3e}")
    if abs(vcs[device] - GOLDEN_VC) > 5e-3:
        raise AssertionError("validation VC is off the golden value")
    if abs(vcs[device] - vcs["cpu"]) > 1e-4:
        raise AssertionError(f"validation VC on {device} is off the CPU's")

    with open(GOLDEN_SYN) as f:
        golden = json.load(f)
    net = load_model(CKPT, device=device)
    t0 = time.perf_counter()
    rows = evaluate_synthetic_generated(net, list(sizes), n_graphs=n_graphs, seed=0,
                                        device=device)
    log(f"golden synthetic sweep: {time.perf_counter() - t0:.2f} s")
    for r, ref in zip(rows, golden["model"]):
        log("synthetic row: " + json.dumps(dict(
            size=r["size"], score_mean=r["score_mean"], golden_score_mean=ref["score_mean"],
            score_std=r["score_std"], golden_score_std=ref["score_std"],
            cost_mean=r["cost_mean"], golden_cost_mean=ref["cost_mean"],
            time_mean_s=r["time_mean"])))
        # the rtol of tests/test_torch_small_greedy.py's CPU check
        if r["size"] != ref["size"] or not all(
                math.isclose(r[k], ref[k], rel_tol=1e-5, abs_tol=0.0)
                for k in ("score_mean", "score_std", "cost_mean")):
            raise AssertionError("a synthetic row is off its golden value")
    return vcs


def _q_pair(net, bd, prefix):
    """Both engines' Q after removing `prefix` one by one (blocked: K4;
    segment: the plain segment sum)."""
    import torch

    from mdcommunity_tpu_torch.env.env import batched_reset, batched_step
    from mdcommunity_tpu_torch.graphs.duplex import stack_graphs
    from mdcommunity_tpu_torch.models.net import make_blocked_aggregate
    from mdcommunity_tpu_torch.rl.dqn import predict_q

    gb = stack_graphs([bd.g])
    state = batched_reset(gb)
    for a in prefix:
        state, _ = batched_step(gb, state, torch.tensor([int(a)], device=gb.device))
    qb = predict_q(net, gb, state.covered, state.sever, dense=False,
                   aggregate_fn=make_blocked_aggregate(bd))
    qs = predict_q(net, gb, state.covered, state.sever, dense=False)
    return qb[0].cpu().numpy(), qs[0].cpu().numpy()


def blocked_phase(device, n, step, max_steps):
    """The blocked path on the card: dismantle_greedy over the BlockedDuplex
    (every model call aggregates with K4), counts set to 0 just before and
    read just after, against the segment engine on the same graph and
    ordering.  Removals must be identical up to the first decision that
    hangs on a gap below f32 rounding (TIE of max|Q| in both engines, the
    rule of tests/test_torch_greedy.py)."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.eval.metrics import dismantle_greedy
    from mdcommunity_tpu_torch.models.checkpoint import load_model

    net = load_model(CKPT, device=device)
    t0 = time.perf_counter()
    bd = blocked_graph(n, device)
    log(f"blocked build: n={n} pad_n={bd.pad_n} pairs={[b.n_pairs for b in bd.bcoo]} "
        f"max_rank={int(bd.g.max_rank)} {time.perf_counter() - t0:.2f} s")
    runs = {}
    for engine in ("blocked", "segment"):
        reset_all_launches()
        stats = {}
        t0 = time.perf_counter()
        if engine == "blocked":
            sol, score, _ = dismantle_greedy(net, bd, step=step, max_steps=max_steps,
                                             stats=stats)
        else:
            sol, score, _ = dismantle_greedy(net, bd.g, step=step, max_steps=max_steps,
                                             dense=False, stats=stats)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = all_launches()
        calls = max(stats["model_calls"], 1)
        runs[engine] = dict(sol=sol, score=score, counts=counts, calls=calls)
        log(f"blocked path, {engine} engine: " + json.dumps(dict(
            n=n, step=step, removed=len(sol), score=score, wall_s=time.perf_counter() - t0,
            model_calls=stats["model_calls"],
            mean_model_call_ms=1e3 * stats["model_call_s"] / calls,
            k4_launches_per_call=counts["spmm_block"] / calls, launches=counts)))
    b, s = runs["blocked"]["sol"], runs["segment"]["sol"]
    if len(b) < min(max_steps, 100) or len(set(b)) != len(b):
        raise AssertionError("blocked path result out of range")
    k = next((i for i, (x, y) in enumerate(zip(b, s)) if x != y), None)
    if k is None:
        if b != s:
            raise AssertionError("the engines removed different numbers of nodes")
        log(f"blocked vs segment engine: identical removals ({len(b)})")
    else:
        k0 = (k // step) * step  # the model call that ordered removal k
        qb, qs = _q_pair(net, bd, b[:k0])
        tie = TIE * np.abs(qb[np.isfinite(qb)]).max()
        a_b, a_s = b[k], s[k]
        log(f"blocked vs segment engine: first difference at removal {k} (call from "
            f"{k0}): blocked takes {a_b} (Q {qb[a_b]:.9e} / segment {qs[a_b]:.9e}), "
            f"segment takes {a_s} (Q {qs[a_s]:.9e} / blocked {qb[a_s]:.9e}), tie {tie:.3e}")
        if not (qb[a_b] >= qb[a_s] and qs[a_s] >= qs[a_b]
                and qb[a_b] - qb[a_s] <= tie and qs[a_s] - qs[a_b] <= tie):
            raise AssertionError("the engines part at a decision that is not a near-tie")
    if device != "cpu" and runs["blocked"]["counts"]["spmm_block"] != 6 * runs["blocked"]["calls"]:
        raise AssertionError("K4 did not run 6 times a model call")
    return bd, net, runs["blocked"]["counts"]


def blocked_gradient_phase(bd, net):
    """The blocked aggregation's VJP on the path: the gradient of ΣQ over a
    BlockedDuplex's live nodes in the parameters and in the live-edge
    weights (BlockSpmm's backward: K4 on the gradient for dh, K5 for dw),
    counts set to 0 just before and read just after, held against the same
    gradient through the segment engine (plain segment sums)."""
    import copy
    import dataclasses

    import torch

    from mdcommunity_tpu_torch.env.batch import make_batch_inputs
    from mdcommunity_tpu_torch.env.env import batched_reset
    from mdcommunity_tpu_torch.graphs.duplex import stack_graphs
    from mdcommunity_tpu_torch.models.net import make_blocked_aggregate, test_forward

    gb = stack_graphs([bd.g])
    state = batched_reset(gb)
    inputs = make_batch_inputs(gb, state.covered, state.sever, dense=False)
    res = []
    for agg in (make_blocked_aggregate(bd), None):
        net2 = copy.deepcopy(net).requires_grad_()
        lw = inputs.live_w.clone().requires_grad_()
        reset_all_launches()
        q = test_forward(net2, gb, dataclasses.replace(inputs, live_w=lw), aggregate_fn=agg)
        loss = torch.sum(torch.where(inputs.active, q, torch.zeros_like(q)))
        loss.backward()
        if gb.device.type != "cpu":
            torch.cuda.synchronize()
        res.append((all_launches(), lw.grad, {k: p.grad for k, p in net2.named_parameters()}))
    (counts, dw, gp), (_, dw_ref, gp_ref) = res
    log("blocked gradient: launches " + json.dumps(counts))
    # padding slots' gradients differ by layout (K5 reads h[src_blk·S], the
    # segment engine h[0]) and feed nothing: compare the real edges
    real = gb.edge_mask
    err = compare("blocked gradient d(ΣQ)/dw vs segment engine (real edges)", dw[real],
                  dw_ref[real])
    worst = max((gp[k] - gp_ref[k]).abs().max().item() / max(gp_ref[k].abs().max().item(), 1e-30)
                for k in gp)
    log(f"blocked gradient: parameters vs segment engine, worst leaf error {worst:.3e} "
        "of its max |grad|")
    if not math.isfinite(worst) or worst > REL_TOL:
        raise AssertionError("blocked gradient: the parameter gradients disagree")
    return counts, err


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

    from mdcommunity_tpu_torch.utils.device import set_precise_matmul

    set_precise_matmul()
    if args.rehearse:
        from mdcommunity_tpu_torch.native import build as native_build

        native_build.build()
        check_kernels("cpu", 2048)
        check_backward("cpu", 2048)
        time_kernels("cpu", synth_banded(2048, True, 0, "cpu"), "rehearsal")
        check_blocked("cpu")
        small_bd = blocked_graph(2048, "cpu", max_rank=0)
        time_blocked("cpu", small_bd, "rehearsal")
        check_blocked_backward("cpu", small_bd)
        main_path("cpu", 2048, 0.01)
        check_fit("cpu", 2048)
        small, edges = synth_banded(2048, False, 0, "cpu", reorder=False, with_edges=True)
        trainer_phase("cpu", small, edges, 16)
        fit_memory("cpu", small, 16)
        small_graph_phase("cpu")
        bd, net = blocked_phase("cpu", 2048, 4, 40)[:2]
        blocked_gradient_phase(bd, net)
        log("rehearsal done")
        return 0
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs one GPU")
    device = "cuda"
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()
    errs = check_kernels(device, 1 << 16)
    errs["band_spmm_bwd"] = check_backward(device, 1 << 16)

    main_graph = synth_banded(18222, True, 0, device)
    times = time_kernels(device, main_graph, "18,432 rows")
    del main_graph
    big, big_edges = synth_banded(1 << 20, False, 0, device, reorder=False,
                                  with_edges=True)
    time_kernels(device, big, "2^20 rows")
    torch.cuda.empty_cache()
    blocked_errs, blocked_times = blocked_kernel_phases(device)

    counts, result = main_path(device, 18222, 0.001)
    for k in ("band_spmm", "band_sage"):
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"main path AUDC {result['audc']:.6f} after {result['removed']} removals")

    fit_err = check_fit(device, 18222)
    train_counts = trainer_phase(device, big, big_edges, 1048)
    fit_memory(device, big, 1048)
    del big
    torch.cuda.empty_cache()

    small_graph_phase(device)
    bd, net, blocked_counts = blocked_phase(device, 18222, 18, BLOCKED_STEPS)
    grad_counts, grad_err = blocked_gradient_phase(bd, net)
    blocked_errs["sddmm_block"] = max(blocked_errs["sddmm_block"], grad_err)
    for name, c in (("spmm_block", blocked_counts), ("spmm_block_bwd", grad_counts),
                    ("sddmm_block", grad_counts)):
        if c[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on its path")

    kernels = []
    for name, launched, replaces in (
        ("band_spmm", counts, "259"), ("band_sage", counts, "259"),
        ("band_spmm_bwd", train_counts, "822"),
    ):
        t = dict(times[name])
        t["max_abs_err"] = max(errs[name], t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/band.cu",
            replaces=f"mdcommunity_tpu/ops/band_pallas.py:{replaces}",
            launches=launched[name], **t))
    for name, launched, replaces in (
        ("spmm_block", blocked_counts, "184"), ("spmm_block_bwd", grad_counts, "184"),
        ("sddmm_block", grad_counts, "309"),
    ):
        t = dict(blocked_times[name])
        t["max_abs_err"] = max(blocked_errs[name], t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/blocked.cu",
            replaces=f"mdcommunity_tpu/ops/pallas_spmm.py:{replaces}",
            launches=launched[name], **t))
    log(f"fit gradient vs CPU f64: worst leaf error {fit_err:.3e} of its max |grad|")
    log(gpu_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def blocked_kernel_phases(device):
    """K4 and K5 checked (random layout; BlockSpmm's backward at 18,432
    rows) and timed at the 18,432-row and the 2^20-row layouts.  Returns
    (max abs errors, the 18,432-row times) by kernel name."""
    import torch

    errs = check_blocked(device)
    bd = blocked_graph(18222, device, max_rank=0)
    errs["spmm_block_bwd"] = check_blocked_backward(device, bd)
    times = time_blocked(device, bd, "18,432 rows")
    del bd
    big = blocked_graph(1 << 20, device, max_rank=0)
    time_blocked(device, big, "2^20 rows")
    del big
    torch.cuda.empty_cache()
    return errs, times


if __name__ == "__main__":
    sys.exit(main())
