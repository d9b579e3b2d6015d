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
     col) against autograd through the plain operator; and K1's and K2's
     bf16 modes (precise=False), h stored in f32 and in bf16, each launched
     twice for bit-identical output;
  3. time K1, K2, K1's backward, the bf16 modes, their plain versions and a
     library yardstick (torch.bmm of the widened band against materialised
     windows, in bf16 for the bf16 modes) at the main path's shapes, 18,432
     and 2^20 rows with D=64, each beside its bound;
  4. drive the main path: large-graph greedy dismantling of the 18,222-node
     shuffled synthetic duplex of `large_graph_demo --sizes 18222` by the
     committed unit-cost checkpoint, through eval.real.evaluate_real
     (StepRatio 0.001, one host cascade per batch, native host engine), with
     every kernel's launch count set to 0 just before and read just after;
     its first forward is held against the same forward on the CPU; then
     the fast eval's main path, `cli test-real --fast --packed` in-process
     on the same file (its first forward held to the CPU's fast forward),
     and one fast model call in each mode (fused or not, f32 or bf16
     storage), with counts set to 0 just before and read just after;
  5. hold one fit's loss and parameter gradients on the card to the CPU's
     (18,222 nodes, the fine-tuning checkpoint, 1,048 actions);
  6. drive the training path: 6 iterations of rl.big_trainer's loop at k =
     1,048 on a spill-free 2^20-node build (selection runs K2, every fit's
     gradient K1 with swapped scales), counts set to 0 just before and read
     just after, and one fit's peak memory with and without remat;
  7. check and time K4 and K5, run the small-graph validation and golden
     synthetic rows, and the 18,222-node blocked dismantling against the
     segment engine with one blocked gradient;
  8. the gp-sharded band engine, GP = 4 shards on the one card: K3 (the
     halo-mode band kernel, band_halo) in its three modes against its plain
     version on two 2^16-row graphs (interior and boundary launches, and
     one launch a shard), the sharded operator and its backward against K1
     and BandSpmm on the whole graph (max abs difference 0); K3's times at
     18,432 and 2^20 rows beside K1's; the sharded model call at 2^20 nodes,
     precise and fast, against the unsharded one; and 6 iterations of the
     sharded trainer loop at 2^20 beside the unsharded loop (the same
     removals), counts set to 0 just before and read just after;
  9. the band kernel's last TPU modes and the stream probe: nibble storage
     against int8 (max abs difference 0) in K1, K1's backward, K2 with
     either epilogue and K3 in the three modes after a batch of severs with
     duplicates and both cells of one byte, and against the plain versions;
     K2's bf16 epilogue (f32_epi=False) within EPI_TOL of its plain version;
     K1's diag variants (noscale, nodot, noh, hlin; f32 and bf16) against
     their references; the stream probe (probe.cu) exactly; their times at
     18,432 and 2^20 rows beside bound, plain and library; then the slice's
     path, the four probe entry points through their mains (probe_f32_epi at
     18,222 nodes, bench_nibble, tune_band --diag and probe_hbm_roof at
     2^20), counts set to 0 just before and read just after.
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
PEAK_BF16_S = 989e12     # H100 SXM bf16 tensor cores, dense
REL_TOL = 1e-4           # kernel vs plain: f32 sums in another order
# the fast forward on the card vs on the CPU, in units of max|Q|.  TF32
# dense layers round each operand to 10 bits (2^-11 relative) where the
# CPU's are f32; that moves a quarter of the bf16 operands of the next round
# (their ulp is 2^-8) to a neighbouring bf16 value, each by one ulp; through
# three rounds and the Q head that stays below FAST_Q_TOL.  With the dense
# layers in f32 on both sides only the f32 sums differ: a bf16 operand within
# that noise of a rounding boundary moves by one ulp, rarely, so nearly all
# nodes agree to F32_Q_TOL (a share of F32_Q_SHARE: the CPU tests ask 99% at
# up to 4,096 nodes; the 18,222-node graph has more rounding events) and all
# to FLIP_Q_TOL (tests/test_torch_fast.py)
FAST_Q_TOL = 1e-2
F32_Q_TOL, F32_Q_SHARE, FLIP_Q_TOL = 1e-5, 0.95, 2 ** -7
TIE = 1e-5               # of max|Q|: a gap no f32 forward of this depth resolves
# the sharded precise forward vs the unsharded one, of max|Q|: the same
# kernels' bits, but cuBLAS picks another f32 GEMM kernel for a shard's rows
# than for the whole graph's (sharded_forward_phase logs the dense layer's
# difference), and those last-bit differences pass through three rounds
SHARD_Q_TOL = 1e-5
BLOCKED_STEPS = 720      # removals of the blocked path's run (step 18): about a minute
GOLDEN_VC = 0.1194451824  # tests/test_golden_models.py, unit cost, 32 graphs
GOLDEN_SYN = os.path.join(HERE, "results_tpu", "golden_synthetic", "golden.json")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- build


def build_all():
    from mdcommunity_tpu_torch.native import build as native_build
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels, probe_kernels

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
        threading.Thread(target=run, args=("probe.cu (nvcc)", probe_kernels.build)),
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
    for name in ("band", "blocked", "probe"):
        with open(os.path.join(os.path.dirname(band_kernels.LIB), f"{name}_ptxas.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}:", line.strip())


# ---------------------------------------------------------------- graphs


def synth_banded(n, shuffle, seed, device, reorder=True, with_edges=False, S=256,
                 nibble=False, simple=False):
    """A large_graph_demo graph's banded build (block size S, nibble storage
    with nibble=True); simple=True keeps each undirected edge once (the
    generator repeats some, and at 2^20 nodes a band cell then exceeds a
    nibble's 7); with_edges=True also returns its ordered edge lists (for a
    host env)."""
    import numpy as np

    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(seed), shuffle=shuffle)
    if simple:
        e0, e1 = (np.unique(np.sort(e, axis=1), axis=0) for e in (e0, e1))
    banded, _, edges = build_banded_duplex(n, e0, e1, S=S, reorder=reorder, max_rank=0,
                                           device=device, nibble=nibble)
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


def time_ms(fn):
    """Median device ms of fn (utils/timing.cuda_ms).  The CPU rehearsal has
    no device clock: it calls fn once and times nothing (NaN)."""
    import torch

    from mdcommunity_tpu_torch.utils.timing import cuda_ms

    if torch.cuda.is_available():
        return cuda_ms(fn)
    fn()
    return float("nan")


def widened(dbg, dtype):
    """The stored base [nb, S+C, W2] in `dtype` (a nibble base unpacked),
    the left operand of the library yardstick torch.bmm."""
    from mdcommunity_tpu_torch.ops.dense_band import unpack_nibbles

    return (unpack_nibbles(dbg.base) if dbg.nibble else dbg.base).to(dtype)


def bounds(dbg, D, sage, store_bytes=4, band_rate=PEAK_F32_S, halo=0, epi_rate=PEAK_F32_S):
    """Least time for the function on these inputs: each input read once,
    the output written once (h and the output at their storage width), over
    the card's memory rate; the operations this data needs: one multiply-add
    per band nonzero and column at `band_rate` (FP32, or the bf16 tensor
    cores for the bf16 modes), K2's two D×D products at `epi_rate` (FP32, or
    the bf16 tensor cores for the bf16 epilogue, whose operands are bf16
    with f32 sums), and the mirror add, the row scale (K2 also the
    normalisation) at the FP32 rate.  halo: rows of h (with their col
    scales) read besides the graph's own (K3: the two B-row halos of a
    shard).  A nibble base counts at its stored half of the bytes.  Returns
    (ms, bound_by)."""
    from mdcommunity_tpu_torch.ops.dense_band import band_rows

    nb, S, C, pad_n = dbg.n_blocks, dbg.S, dbg.C, dbg.pad_n
    nnz = int((band_rows(dbg) != 0).sum().item())
    base_w = dbg.W2 // 2 if dbg.nibble else dbg.W2   # nibbles: half the bytes
    byts = (nb * S * base_w + 2 * pad_n * D * store_bytes + 2 * pad_n * 4
            + nb * C * D * 4 + nb * S * 4 + halo * (D * store_bytes + 4))
    f32_ops, epi_ops = 2 * pad_n * D, 0
    if sage:
        byts += 2 * D * D * 4
        f32_ops += 3 * pad_n * D
        epi_ops = 2 * 2 * pad_n * D * D
    t_b = byts / PEAK_BYTES_S
    t_o = 2 * nnz * D / band_rate + epi_ops / epi_rate + f32_ops / PEAK_F32_S
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
    base_f = widened(dbg, torch.float32)
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
    base_f = widened(dbg, torch.float32)
    win = _windows(g * row[:, None], dbg.n_blocks, dbg.S, dbg.B).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.bmm(base_f, win))
    del base_f, win
    res, nib = {}, "_nib" if dbg.nibble else ""
    for name, kern, plain, sage, lib in (
        ("band_spmm", lambda: bk.spmm_band(dbg, live, live, h, sub),
         lambda: bk.spmm_band_plain(dbg, live, live, h, sub), False, lib_ms),
        ("band_sage", lambda: bk.sage_step(dbg, live, live, h, sub, aw, bw),
         lambda: bk.sage_step_plain(dbg, live, live, h, sub, aw, bw), True, lib_ms),
        ("band_spmm_bwd", lambda: bk.spmm_band(dbg, col, row, g, sub_g, "band_spmm_bwd"),
         lambda: bk.spmm_band_plain(dbg, col, row, g, sub_g), False, lib_bwd_ms),
    ):
        bound_ms, bound_by = bounds(dbg, 64, sage)
        res[name + nib] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib,
                               max_abs_err=errs[name])
        log(f"time {label} {name + nib}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(res[name + nib]))
    return res


# ---------------------------------------------------------------- bf16 modes

# (counter, kernel, storage) of K1's and K2's bf16 modes
BF16_MODES = (
    ("band_spmm_bf16", "spmm", "float32"), ("band_spmm_bf16_act", "spmm", "bfloat16"),
    ("band_sage_bf16", "sage", "float32"), ("band_sage_bf16_act", "sage", "bfloat16"),
)


def compare_bf16(name, got, ref):
    """A bf16-storage output against its plain version: within one bf16 ulp
    of each element (the f32 sums before the rounding run in another order)
    plus REL_TOL of max|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    excess = ((got - ref).abs() - ulp - REL_TOL * scale).max().item()
    err = (got - ref).abs().max().item()
    log(f"check {name}: max_abs_err {err:.3e}  max|ref| {scale:.3e}  "
        f"worst excess over 1 bf16 ulp + REL_TOL·max {excess:.3e}")
    if not torch.isfinite(got).all() or excess > 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def bf16_mode_fns(dbg, live, h32, aw, bw, kernel, store):
    """(kernel call, plain call) of one bf16 mode on the col = row = live
    operands; h is stored in `store`."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    h = h32.to(getattr(torch, store)).contiguous()
    sub = mirror_sub(dbg, live, h, precise=False)
    if kernel == "spmm":
        return (lambda: bk.spmm_band(dbg, live, live, h, sub, precise=False),
                lambda: bk.spmm_band_plain(dbg, live, live, h, sub, precise=False))
    return (lambda: bk.sage_step(dbg, live, live, h, sub, aw, bw, precise=False),
            lambda: bk.sage_step_plain(dbg, live, live, h, sub, aw, bw, precise=False))


def check_bf16_mode(label, name, kern, plain):
    """Kernel vs plain version, and two launches bit-identical."""
    import torch

    got, ref = kern(), plain()
    if got.dtype == torch.bfloat16:
        err = compare_bf16(f"{label} {name}", got, ref)
    else:
        err = compare(f"{label} {name}", got, ref)
    if not torch.equal(kern(), got):
        raise AssertionError(f"{label} {name}: two launches differ")
    return err


def check_bf16_kernels(device, n):
    """K1's and K2's bf16 modes, both storages, against their plain versions
    on the 2^16-node check graphs (A: mirror lanes and spill, K1 at D = 64
    and D = 2; B: mirror lanes and no spill, K2)."""
    import torch

    errs = {}
    dbg = synth_banded(n, True, 1, device).dbg0
    h, live = operands(dbg, 64, 2, device)
    h2, ones = operands(dbg, 2, 3, device, unit=True)
    clean = synth_banded(n, False, 1, device).dbg0
    hc, live_c = operands(clean, 64, 4, device)
    hc = torch.nn.functional.normalize(hc, dim=-1)
    aw, bw = sage_weights(device)
    for name, kernel, store in BF16_MODES:
        if kernel == "spmm":
            errs[name] = max(
                check_bf16_mode("bf16 D=64", name,
                                *bf16_mode_fns(dbg, live, h, aw, bw, kernel, store)),
                check_bf16_mode("bf16 D=2", name,
                                *bf16_mode_fns(dbg, ones, h2, aw, bw, kernel, store)))
        else:
            errs[name] = check_bf16_mode(
                "bf16", name, *bf16_mode_fns(clean, live_c, hc, aw, bw, kernel, store))
    return errs


def time_bf16_kernels(device, banded, label):
    """Each bf16 mode at D = 64 beside its bound, its plain version and the
    library yardstick (torch.bmm of the bf16-widened band against
    materialised bf16(col ⊙ h) windows), after a check at these shapes.
    Also logs the time of the dense formulation the kernel runs, 2·rows·W2·D
    at the bf16 rate."""
    import torch

    from mdcommunity_tpu_torch.ops.band_kernels import _windows

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    aw, bw = sage_weights(device)
    base_b = widened(dbg, torch.bfloat16)
    win = _windows((h * live[:, None]).to(torch.bfloat16), dbg.n_blocks, dbg.S,
                   dbg.B).contiguous()
    lib_ms = time_ms(lambda: torch.bmm(base_b, win))
    del base_b, win
    res, nib = {}, "_nib" if dbg.nibble else ""
    for name, kernel, store in BF16_MODES:
        kern, plain = bf16_mode_fns(dbg, live, h, aw, bw, kernel, store)
        err = check_bf16_mode(label, name, kern, plain)
        bound_ms, bound_by = bounds(dbg, 64, kernel == "sage",
                                    2 if store == "bfloat16" else 4, PEAK_BF16_S)
        res[name + nib] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                               max_abs_err=err)
        dense_ms = 1e3 * 2 * dbg.pad_n * dbg.W2 * 64 / PEAK_BF16_S
        log(f"time {label} {name + nib}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(dict(res[name + nib], dense_formulation_ms=dense_ms)))
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
    for name in ("band_spmm", "band_sage", "band_spmm_bwd"):
        if on_card and counts[name] <= 0:
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


# ---------------------------------------------------------------- K3: the gp-sharded band operator

GP = 4  # gp shards, all on the one card
# (counter, precise, storage) of K3's modes
HALO_MODES = (("band_halo", True, "float32"), ("band_halo_bf16", False, "float32"),
              ("band_halo_bf16_act", False, "bfloat16"))


def halo_operands(mesh, sdbg, row, col, h, precise):
    """Each shard's K3 operands (shard, row, col, h, lh, rh, lc, rc, sub) for
    the whole-graph row, col and h: the sharded call's split, ring halos and
    mirror slices."""
    from mdcommunity_tpu_torch.parallel.band_partition import mirror_subs
    from mdcommunity_tpu_torch.parallel.mesh import ring_halos, split_nodes

    rows, cols, hs = (split_nodes(mesh, x) for x in (row, col, h))
    lh, rh = ring_halos(mesh, hs, sdbg.B)
    lc, rc = ring_halos(mesh, cols, sdbg.B)
    subs = mirror_subs(sdbg, cols, hs, precise)
    return list(zip(sdbg.shards, rows, cols, hs, lh, rh, lc, rc, subs))


def check_halo_kernels(device, n, gp=GP):
    """K3 in its three modes on two n-row graphs (the unshuffled check graph)
    split over gp shards: blocks of S = 256 (nb_l >= 3: interior and boundary
    launches) and of S = n / (2·gp) (nb_l = 2: one launch a shard).  Each
    shard's launch against spmm_band_halo_plain on the card; the sharded
    operator against K1 on the whole graph (spmm_dense_band) and its
    backward (ShardedBandSpmm, K3 with swapped scales) against BandSpmm's:
    max abs difference 0 on the card, or this raises.  Returns max abs errors by
    counter."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band, spmm_dense_band_grad
    from mdcommunity_tpu_torch.parallel.band_partition import (
        shard_band_graph,
        spmm_band_sharded,
        spmm_band_sharded_grad,
    )
    from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, make_mesh, split_nodes

    mesh = make_mesh(gp, device)
    errs = dict.fromkeys([m[0] for m in HALO_MODES] + ["band_halo_bwd"], 0.0)
    # bits on the card; the CPU rehearsal's plain einsums may sum a block in
    # another order when their batch of blocks differs (2^-7: bf16 storage)
    exact = 0.0 if device != "cpu" else 2.0 ** -7
    for S in (min(256, n // (4 * gp)), n // (2 * gp)):
        dbg = synth_banded(n, False, 1, device, S=S).dbg0
        sdbg = shard_band_graph(mesh, dbg)
        nb_l = sdbg.shards[0].n_blocks
        log(f"K3 check graph: n={n} S={S} C={dbg.C} gp={gp} nb_l={nb_l}")
        h, _ = operands(dbg, 64, 2, device)
        row, col = scales(dbg, 7, device)
        for name, precise, store in HALO_MODES:
            hh = h.to(getattr(torch, store)).contiguous()
            for i, op in enumerate(halo_operands(mesh, sdbg, row, col, hh, precise)):
                got = bk.spmm_band_halo(*op, precise=precise)
                ref = bk.spmm_band_halo_plain(*op, precise=precise)
                cmp = compare_bf16 if store == "bfloat16" else compare
                errs[name] = max(errs[name], cmp(f"K3 {name} S={S} shard {i}", got, ref))
            out = gather_nodes(mesh, spmm_band_sharded(
                mesh, sdbg, *(split_nodes(mesh, x) for x in (row, col, hh)), precise=precise))
            k1 = spmm_dense_band(dbg, row, col, hh, precise=precise)
            diff = (out.float() - k1.float()).abs().max().item()
            log(f"check K3 {name} S={S}: sharded operator vs K1 on the whole graph, "
                f"max abs difference {diff}")
            if diff > exact * k1.float().abs().max().item():
                raise AssertionError(f"{name}: the sharded operator is not K1's bits")
        gen = torch.Generator().manual_seed(8)
        g = torch.randn(dbg.pad_n, 64, generator=gen).to(device)
        hs = [x.clone().requires_grad_() for x in split_nodes(mesh, h)]
        dh = torch.autograd.grad(spmm_band_sharded_grad(
            mesh, sdbg, split_nodes(mesh, row), split_nodes(mesh, col), hs), hs,
            split_nodes(mesh, g))
        dh = gather_nodes(mesh, list(dh))
        hf = h.clone().requires_grad_()
        (ref,) = torch.autograd.grad(spmm_dense_band_grad(dbg, row, col, hf), hf, g)
        diff = (dh - ref).abs().max().item()
        log(f"check K3 backward S={S}: ShardedBandSpmm vs BandSpmm, max abs difference {diff}")
        if diff > exact * ref.abs().max().item():
            raise AssertionError("the sharded backward is not BandSpmm's bits")
        (plain,) = torch.autograd.grad(plain_operator(dbg, row, col, hf), hf, g)
        errs["band_halo_bwd"] = max(errs["band_halo_bwd"], compare(
            f"K3 backward S={S} vs autograd through the plain operator", dh, plain))
    return errs


def time_halo_kernels(device, banded, label, gp=GP):
    """K3 in each mode, and as the backward (row and col swapped, on a
    gradient), at D = 64 on layer 0 of `banded` split over gp shards: each
    shard's interior and boundary launches, the K3 launches of one sharded
    call (all shards) beside their plain versions, the library yardstick
    (torch.bmm of each shard's widened base against its materialised linear
    windows, bf16 for the bf16 modes) and the bound (each shard's base, h,
    halos, scales, mirror slice and output once); the whole sharded call
    (mirror glue and halos included) beside K1's whole-graph operator; and
    the launches of one sharded call.  Returns the whole-call numbers by
    counter."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band
    from mdcommunity_tpu_torch.parallel.band_partition import (
        block_split,
        shard_band_graph,
        spmm_band_sharded,
    )
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh, split_nodes

    mesh = make_mesh(gp, device)
    dbg = banded.dbg0
    sdbg = shard_band_graph(mesh, dbg)
    nb_l = sdbg.shards[0].n_blocks
    split = [b for ranges in block_split(nb_l) for b in ranges]  # a sharded call's order
    h32 = torch.nn.functional.normalize(operands(dbg, 64, 5, device)[0], dim=-1)
    g32 = torch.nn.functional.normalize(operands(dbg, 64, 10, device)[0], dim=-1)
    row, col = scales(dbg, 9, device)
    res, nib = {}, "_nib" if dbg.nibble else ""
    for name, precise, store in HALO_MODES + (("band_halo_bwd", True, "float32"),):
        dt = getattr(torch, store)
        if name == "band_halo_bwd":  # the gradient's operator: col and row swapped
            r, c, h = col, row, g32
        else:
            r, c, h = row, col, h32.to(dt).contiguous()
        ops = halo_operands(mesh, sdbg, r, c, h, precise)
        outs = [torch.empty_like(op[3]) for op in ops]

        def launch(i, blocks, plain=False):
            op = ops[i]
            if plain:
                return bk.spmm_band_halo_plain(*op, blocks=blocks, precise=precise)
            halo = op[4:8] if blocks[0] == 0 or blocks[1] == nb_l else (None,) * 4
            return bk.spmm_band_halo(*op[:4], *halo, op[8], blocks, outs[i], name, precise)

        def kern():
            for i in range(gp):
                for blocks in split:
                    launch(i, blocks)

        def plain():
            for i in range(gp):
                for blocks in split:
                    launch(i, blocks, plain=True)

        kern()
        cmp = compare_bf16 if store == "bfloat16" else compare
        err = max(cmp(f"{label} K3 {name} shard {i}", outs[i],
                      bk.spmm_band_halo_plain(*ops[i], precise=precise)) for i in range(gp))
        per_shard = []
        for i in range(gp):
            t = {f"{b0}-{b1}": time_ms(lambda: launch(i, (b0, b1))) for b0, b1 in split}
            per_shard.append(t)
        wins, bases = [], []
        for op in ops:
            shard, _, cc, x, lh, rh, lc, rc, _ = op
            lib_dt = torch.float32 if precise else torch.bfloat16
            ext = torch.cat([lh.float() * lc[:, None], x.float() * cc[:, None],
                             rh.float() * rc[:, None]]).to(lib_dt)
            wins.append(ext.unfold(0, shard.W2, shard.S).transpose(1, 2).contiguous())
            bases.append(widened(shard, lib_dt))
        lib_ms = time_ms(lambda: [torch.bmm(a, w) for a, w in zip(bases, wins)])
        del wins, bases
        sb = [bounds(s, 64, False, 2 if store == "bfloat16" else 4,
                     PEAK_F32_S if precise else PEAK_BF16_S, halo=2 * sdbg.B)
              for s in sdbg.shards]
        bound_ms = sum(b[0] for b in sb)
        rows_, cols_, hs_ = (split_nodes(mesh, x) for x in (r, c, h))
        bk.reset_launches()
        spmm_band_sharded(mesh, sdbg, rows_, cols_, hs_, precise, name)
        per_call = bk.launches[name + nib]
        res[name + nib] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                               bound_ms=bound_ms, bound_by=sb[0][1], library_ms=lib_ms,
                               max_abs_err=err)
        whole = dict(
            sharded_call_ms=time_ms(lambda: spmm_band_sharded(mesh, sdbg, rows_, cols_, hs_,
                                                              precise, name)),
            k1_whole_graph_ms=time_ms(lambda: spmm_dense_band(dbg, r, c, h, precise=precise)),
            launches_per_call=per_call, shard_ms=per_shard,
            shard_bound_ms=[b[0] for b in sb])
        log(f"time {label} {name + nib}: pad_n={dbg.pad_n} C={dbg.C} gp={gp} nb_l={nb_l} "
            + json.dumps(dict(res[name + nib], **whole)))
    return res


def sharded_forward_phase(device, banded, gp=GP, calls=5):
    """The gp-sharded model call on `banded` (unfused: the fused step is
    single-device), precise and fast (h stored in f32 and in bf16), beside
    the unsharded unfused call: Q against the unsharded forward's (max abs
    difference over max|Q|: within SHARD_Q_TOL precise; fast, with TF32
    dense layers, within FAST_Q_TOL), model-call ms (forward + stable top-k
    + fetch, host clock) for both.  First one dense layer's product per
    shard against the whole graph's (f32).  Counts set to 0 just before
    the sharded calls and read just after; returns them summed."""
    import torch

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import shard_banded_duplex
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    net = load_model(CKPT, device=device)
    sharded = shard_banded_duplex(make_mesh(gp, device), banded)
    covered = ~banded.node_mask
    x = torch.nn.functional.normalize(operands(banded.dbg0, 64, 12, device)[0], dim=-1)
    with matmul_precision(True):
        whole = x @ net.p_node_conv
        pieces = torch.cat([p @ net.p_node_conv for p in torch.chunk(x, gp)])
    log(f"dense layer [{banded.pad_n // gp}, 64] @ [64, 64] per shard vs [{banded.pad_n}, 64]"
        f" whole (f32): max abs diff {(pieces - whole).abs().max().item():.3e}, bit-equal "
        f"{torch.equal(pieces, whole)}")
    k = max(int(0.001 * banded.n_nodes), 1)
    total = dict.fromkeys(bk.launches, 0)
    for precise, act in ((True, torch.float32), (False, torch.float32),
                         (False, torch.bfloat16)):
        def fwd(b):
            with matmul_precision(precise):
                return banded_test_forward(net, b, covered, precise=precise, act_dtype=act)

        ref = fwd(banded)
        bk.reset_launches()
        q = fwd(sharded)
        if device != "cpu":
            torch.cuda.synchronize()
        counts = dict(bk.launches)
        fin = torch.isfinite(ref)
        if not torch.equal(torch.isfinite(q), fin) or not fin.any():
            raise AssertionError("sharded forward: -inf masks differ")
        scale = ref[fin].abs().max().item()
        err = (q[fin] - ref[fin]).abs().max().item() / scale
        ms = {}
        for which, b in (("sharded", sharded), ("unsharded", banded)):
            top_k_stable(fwd(b), k)
            t0 = time.perf_counter()
            for _ in range(calls):
                top_k_stable(fwd(b), k)
            ms[which] = 1e3 * (time.perf_counter() - t0) / calls
        total = {c: total[c] + counts[c] for c in total}
        log("sharded forward: " + json.dumps(dict(
            pad_n=banded.pad_n, gp=gp, precise=precise, act_dtype=str(act).split(".")[1],
            q_err_of_max=err, max_q=scale, model_call_ms=ms["sharded"],
            unsharded_model_call_ms=ms["unsharded"],
            launches={c: v for c, v in counts.items() if v})))
        if err > (SHARD_Q_TOL if precise else FAST_Q_TOL):
            raise AssertionError("the sharded forward's Q differs from the unsharded one's")
        want = ("band_halo" if precise else
                "band_halo_bf16_act" if act == torch.bfloat16 else "band_halo_bf16")
        if device != "cpu" and counts[want] <= 0:
            raise AssertionError(f"the sharded forward did not launch {want}")
    return total


class Recorder:
    """A host env that records each step_many's actions."""

    def __init__(self, env):
        self._env = env
        self.actions = []

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step_many(self, actions, *args, **kw):
        self.actions.append(list(actions))
        return self._env.step_many(actions, *args, **kw)


def sharded_trainer_phase(device, banded, edges, k, gp=GP, iters=6, lr=1e-4):
    """train_banded_loop with mesh = gp shards beside the unsharded loop,
    the same settings for both (unfused, eps_start = eps_end = 1: actions
    from the seeded rng): identical removals at every iteration, first
    losses within 1e-5 relative, final parameters within 2·lr per fit
    (tests/test_torch_big_trainer.py's bound), iteration p50 and peak
    memory for both.  Counts set to 0 just before the sharded loop and read
    just after; band_halo and band_halo_bwd must be launched."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop

    on_card = device != "cpu"
    net = load_model(CKPT_FIT, device=device)
    runs = {}
    for which, mesh in (("unsharded", None), ("sharded", make_mesh(gp, device))):
        env = Recorder(make_host_env(banded.n_nodes, *edges, engine="native"))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        bk.reset_launches()
        net2, hist = train_banded_loop(net, banded, env, iters=iters, k=k, target_update=3,
                                       eps_start=1.0, eps_end=1.0, lr=lr, packed=False,
                                       mesh=mesh, log=log, log_every=iters)
        if on_card:
            torch.cuda.synchronize()
        counts = dict(bk.launches)
        rows = [h for h in hist if "loss" in h]
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        runs[which] = dict(actions=env.actions, rows=rows, counts=counts, peak=peak,
                           params={n: p.detach().double().cpu()
                                   for n, p in net2.named_parameters()})
        log(f"sharded trainer phase, {which}: " + json.dumps(dict(
            pad_n=banded.pad_n, gp=gp if mesh else 1, k=k,
            iter_p50_s=float(np.median([h["t_iter_s"] for h in rows])),
            peak_mem_gib=peak, losses=[h["loss"] for h in rows],
            removed=[h["removed"] for h in rows],
            launches={c: v for c, v in counts.items() if v})))
    u, s = runs["unsharded"], runs["sharded"]
    if u["actions"] != s["actions"] or len(s["actions"]) != iters:
        raise AssertionError("the sharded loop removed other nodes than the unsharded one")
    lu, ls = (np.array([h["loss"] for h in r["rows"]]) for r in (u, s))
    fits = int(np.isfinite(lu).sum())
    if not fits or not np.array_equal(np.isfinite(lu), np.isfinite(ls)):
        raise AssertionError("the loops fitted different iterations")
    rel = abs(ls[0] - lu[0]) / abs(lu[0])
    worst = max((s["params"][n] - p).abs().max().item() for n, p in u["params"].items())
    log(f"sharded vs unsharded loop: first loss rel diff {rel:.3e}, final parameters "
        f"max abs diff {worst:.3e} (bound {2 * lr * fits:.1e})")
    if not rel <= 1e-5 or not worst <= 2 * lr * fits:
        raise AssertionError("the sharded loop's fit differs from the unsharded one's")
    for name in ("band_halo", "band_halo_bwd"):
        if on_card and s["counts"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the sharded trainer phase")
    return s["counts"]


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
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels, probe_kernels

    band_kernels.reset_launches()
    blocked_kernels.reset_launches()
    probe_kernels.reset_launches()


def all_launches():
    from mdcommunity_tpu_torch.ops import band_kernels, blocked_kernels, probe_kernels

    return {**band_kernels.launches, **blocked_kernels.launches, **probe_kernels.launches}


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
    return counts, dict(audc=score, removed=len(sol), mean_model_call_ms=mean_fwd)


def fast_main_path(device, n, step_ratio, precise_result):
    """The fast eval's main path: `cli test-real --fast --packed` in-process
    on main_path's graph file (StepRatio and one cascade per batch as
    there), counts set to 0 just before and read just after.  Its first
    forward on the card is held to the CPU's fast forward within FAST_Q_TOL
    of max|Q|; the TF32 flags are as they were after the run."""
    import contextlib
    import io

    import numpy as np
    import torch

    from mdcommunity_tpu_torch import cli
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    # the graph of `large_graph_demo --sizes n`, as main_path writes it
    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    name = f"synthetic_{n}_multiplex.edges"
    os.makedirs(OUT, exist_ok=True)
    write_edges(os.path.join(OUT, name), e0, e1)
    qs = {}
    for dev in (device, "cpu"):
        banded, _, _ = build_banded_duplex(n, e0, e1, max_rank=0, device=dev)
        net = load_model(CKPT, device=dev)
        for tf32 in (True, False):  # the fast path's dense layers; f32 ones
            with matmul_precision(not tf32):
                qs[dev, tf32] = banded_test_forward(
                    net, banded, ~banded.node_mask, fuse_sage=banded.spill_free,
                    precise=False).cpu()
        if dev == device:
            with matmul_precision(True):
                exact = banded_test_forward(net, banded, ~banded.node_mask,
                                            fuse_sage=banded.spill_free).cpu()
    ref = qs["cpu", True]
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    log(f"fast vs precise first forward on {device}: max err "
        f"{(qs[device, True][fin] - exact[fin]).abs().max().item() / scale:.3e} of max|Q|")
    for tf32 in (True, False):
        q = qs[device, tf32]
        if not torch.equal(torch.isfinite(q), fin) or not fin.any():
            raise AssertionError("fast first forward: -inf masks differ")
        err = (q[fin] - ref[fin]).abs() / scale
        within = (err <= F32_Q_TOL).double().mean().item()
        log(f"fast path first forward vs CPU, dense layers in {'TF32' if tf32 else 'f32'}"
            f" on {device}: max err {err.max().item():.3e} of max|Q| {scale:.3e}, "
            f"{within:.4f} of the nodes within {F32_Q_TOL:.0e}")
        if tf32 and err.max().item() > FAST_Q_TOL:
            raise AssertionError("fast first forward disagrees with the CPU's")
        if not tf32 and (err.max().item() > FLIP_Q_TOL or within < F32_Q_SHARE):
            raise AssertionError("fast first forward (f32 dense layers) disagrees "
                                 "with the CPU's")

    out_dir = os.path.join(OUT, "results_fast")
    argv = ["test-real", "--fast", "--packed", "--model", CKPT, "--data", OUT,
            "-o", out_dir, "--datasets", name, "--n-nodes", str(n), "--layers", "1", "2",
            "--step-ratio", str(step_ratio), "--batch-env"]
    if device == "cpu":
        argv.append("--cpu")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    buf = io.StringIO()
    bk.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    if device != "cpu":
        torch.cuda.synchronize()
    counts = dict(bk.launches)
    wall = time.perf_counter() - t0
    line = buf.getvalue().strip().splitlines()[-1]
    log(f"fast main path (cli {' '.join(argv[:3])} ...): {line}")
    fields = dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
    res = dict(audc=float(fields["audc"]), removed=int(fields["removed"]),
               mean_model_call_ms=float(fields["model_call_ms"]))
    log("fast vs precise main path: " + json.dumps(dict(
        n=n, step_ratio=step_ratio, wall_s=wall, fast=res, precise=precise_result,
        launches=counts)))
    if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != tf32:
        raise AssertionError("the fast run left the TF32 flags changed")
    if device != "cpu":
        if counts["band_spmm_bf16"] + counts["band_sage_bf16"] <= 0:
            raise AssertionError("the fast main path launched no bf16 kernel")
        if counts["band_sage"] != 0:
            raise AssertionError("the fast main path launched the precise K2")
    if not 0.0 < res["audc"] < 1.0:
        raise AssertionError("fast main path result out of range")
    sub = os.path.join(out_dir, f"StepRatio_{step_ratio:.4f}")
    with open(os.path.join(sub, f"NormalizedLMCC_synthetic_{n}_multiplex_12.txt")) as f:
        lines = f.read().split()
    if len(lines) != n + 2 or abs(float(lines[-2]) - res["audc"]) > 5e-7:
        raise AssertionError("fast NormalizedLMCC file malformed")
    with open(os.path.join(sub, f"Soluion_synthetic_{n}_multiplex_12.txt")) as f:
        sol = [int(v) for v in f.read().split()]
    if len(sol) != res["removed"] or len(set(sol)) != len(sol) or not all(
            0 <= v < n for v in sol):
        raise AssertionError("fast Soluion file malformed")
    return counts, res


def fast_forward_phase(device, n):
    """The fast model call in each mode at n nodes (the main path's graph):
    fused or not, h stored in f32 or bf16 (the JAX package's act_dtype),
    counts set to 0 just before each and read just after, with its mean
    model-call ms (forward + stable top-k + fetch, host clock)."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    banded, _, _ = build_banded_duplex(n, e0, e1, max_rank=0, device=device)
    net = load_model(CKPT, device=device)
    covered = ~banded.node_mask
    k = max(int(0.001 * n), 1)
    total = dict.fromkeys(bk.launches, 0)
    for fuse in (False, True):
        if fuse and not banded.spill_free:
            continue
        for act in (torch.float32, torch.bfloat16):
            def call():
                with matmul_precision(False):
                    q = banded_test_forward(net, banded, covered, fuse_sage=fuse,
                                            precise=False, act_dtype=act)
                return top_k_stable(q, k)

            bk.reset_launches()
            call()
            counts = dict(bk.launches)
            reps = 10
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            ms = 1e3 * (time.perf_counter() - t0) / reps
            log("fast forward: " + json.dumps(dict(
                n=n, fuse_sage=fuse, act_dtype=str(act).split(".")[1], model_call_ms=ms,
                launches={c: v for c, v in counts.items() if v})))
            want = "band_{}_bf16{}".format("sage" if fuse else "spmm",
                                           "_act" if act == torch.bfloat16 else "")
            if device != "cpu" and counts[want] <= 0:
                raise AssertionError(f"the fast forward did not launch {want}")
            total = {c: total[c] + counts[c] for c in total}
    return total


# ---------------------------------------------------------------- slice 6

# (counter, precise, storage) of K2's bf16 epilogue (f32_epi=False)
EPI_MODES = (("band_sage_bf16epi", True, "float32"),
             ("band_sage_bf16epi_bf16", False, "float32"),
             ("band_sage_bf16epi_bf16_act", False, "bfloat16"))
PREC_MODES = ((True, "float32"), (False, "float32"), (False, "bfloat16"))
DIAG_NAMES = ("noscale", "nodot", "noh", "hlin")
# K2's bf16 epilogue vs its plain version.  Both round the same operands at
# the same points, but the pooled f32 sums run in another order, so an
# operand within that noise of a bf16 rounding boundary rounds the other way
# in one of them and moves its row's products by one bf16 ulp (2^-8 of it).
# The outputs are l2-normalised (|h'| <= 1): every element within EPI_TOL
# (four bf16 ulps at 1.0) and EPI_SHARE of them within REL_TOL of max (plus
# one bf16 ulp with bf16 storage), since such flips are rare.
EPI_TOL, EPI_SHARE = 2 ** -6, 0.999


def mode_suffix(precise, store):
    return "" if precise else ("_bf16" if store == "float32" else "_bf16_act")


def compare_epi(name, got, ref):
    """K2's bf16 epilogue against its plain version (EPI_TOL, EPI_SHARE)."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    ulp = (torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
           if got.dtype == torch.bfloat16 else 0.0)
    share = (err <= REL_TOL * scale + ulp).float().mean().item()
    worst = err.max().item()
    log(f"check {name}: max_abs_err {worst:.3e}  max|ref| {scale:.3e}  share within "
        f"REL_TOL {share:.6f}")
    if not torch.isfinite(got).all() or worst > EPI_TOL or share < EPI_SHARE:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return worst


def diag_reference(dbg, row, col, h, sub, diag, precise):
    """What K1's timing variant writes: noscale and nodot their plain
    versions; noh (no h staging, no multiply-adds) row ⊙ Gᵀ·sub, K1's plain
    version on h = 0; hlin (each block stages only its own S window rows)
    K1's plain version on a band masked to the window columns [B, B + S).
    noh and hlin define no operator: these are the port kernel's own
    outputs, held so that a launch is seen to do what it says."""
    import dataclasses

    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import band_rows

    if diag in ("noscale", "nodot"):
        return bk.spmm_band_diag_plain(dbg, row, col, h, sub, diag, precise)
    if diag == "noh":
        return bk.spmm_band_plain(dbg, row, col, torch.zeros_like(h), sub, precise)
    base = band_rows(dbg).clone()
    base[:, :, : dbg.B] = 0
    base[:, :, dbg.B + dbg.S:] = 0
    own = dataclasses.replace(dbg, base=base, nibble=False)
    return bk.spmm_band_plain(own, row, col, h, sub, precise)


def check_slice6_kernels(device, n):
    """The modes of this slice against their plain versions, and nibble
    storage against int8, on 2^16-node check graphs.

    Nibble: the unshuffled check graph (mirror lanes, no spill) built with
    int8 and with nibble storage, after one batch of severs with duplicated
    edges, both cells of one base byte and a padding entry
    (bench_nibble.sever_batch): K1, K1's backward (row != col), K2 with
    either epilogue and K3 (GP shards) in the three modes give the int8
    launches' bits (max abs difference 0), and each nibble launch is held to
    its plain version.  K2's bf16 epilogue on the int8 graph (compare_epi).
    K1's diag variants on check graph A (mirror lanes and spill) in the f32
    and bf16 modes against diag_reference.  The stream probe, with and
    without the masked reductions, exactly.  Returns max abs errors by
    counter."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.bench_nibble import sever_batch
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import (
        band_rows, mirror_sub, sever_edges, spmm_dense_band_grad)
    from mdcommunity_tpu_torch.ops.probe_kernels import stream_sum, stream_sum_plain
    from mdcommunity_tpu_torch.parallel.band_partition import (
        shard_band_graph, spmm_band_sharded, spmm_band_sharded_grad)
    from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, make_mesh, split_nodes

    errs = {}

    def keep(name, err):
        errs[name] = max(errs.get(name, 0.0), err)

    g8 = synth_banded(n, False, 1, device).dbg0
    g4 = synth_banded(n, False, 1, device, nibble=True).dbg0
    batch = sever_batch(g8, np.random.default_rng(4))
    for g in (g8, g4):
        sever_edges(g, *batch)
    if not torch.equal(band_rows(g4), g8.base[:, : g8.S]):
        raise AssertionError("the nibble sever does not decode to the int8 sever")
    log(f"nibble check graph: n={n} C={g8.C} spill={g8.spill.nnz}, "
        f"{batch[0].numel()} severs")
    h = torch.nn.functional.normalize(operands(g8, 64, 2, device)[0], dim=-1)
    gg = torch.nn.functional.normalize(operands(g8, 64, 3, device)[0], dim=-1)
    row, col = scales(g8, 7, device)
    aw, bw = sage_weights(device)
    mesh = make_mesh(GP, device)
    split = lambda x: split_nodes(mesh, x)  # noqa: E731
    for precise, store in PREC_MODES:
        m = mode_suffix(precise, store)
        hh, gh = (x.to(getattr(torch, store)).contiguous() for x in (h, gg))
        cmp = compare_bf16 if store == "bfloat16" else compare
        outs = []
        for g in (g8, g4):
            sub, sub_g = mirror_sub(g, col, hh, precise), mirror_sub(g, row, gh, precise)
            o = {
                f"band_spmm{m}": bk.spmm_band(g, row, col, hh, sub, precise=precise),
                "band_spmm_bwd": bk.spmm_band(g, col, row, gh, sub_g, "band_spmm_bwd",
                                              precise),
                f"band_sage{m}": bk.sage_step(g, row, col, hh, sub, aw, bw, precise),
                f"band_sage_bf16epi{m}": bk.sage_step(g, row, col, hh, sub, aw, bw, precise,
                                                      f32_epi=False),
                f"band_halo{m}": gather_nodes(mesh, spmm_band_sharded(
                    mesh, shard_band_graph(mesh, g), split(row), split(col), split(hh),
                    precise)),
            }
            if precise:   # the autograd backwards: BandSpmm and ShardedBandSpmm
                x = h.clone().requires_grad_()
                (o["band_spmm_bwd_autograd"],) = torch.autograd.grad(
                    spmm_dense_band_grad(g, row, col, x), x, gg)
                xs = [p.clone().requires_grad_() for p in split(h)]
                o["band_halo_bwd"] = gather_nodes(mesh, list(torch.autograd.grad(
                    spmm_band_sharded_grad(mesh, shard_band_graph(mesh, g), split(row),
                                           split(col), xs), xs, split(gg))))
            outs.append(o)
        for name in outs[0]:
            diff = (outs[0][name].float() - outs[1][name].float()).abs().max().item()
            log(f"check nibble {name}{' (' + store + ')' if not precise else ''}: "
                f"max abs difference against int8 {diff}")
            if not torch.equal(outs[0][name], outs[1][name]):
                raise AssertionError(f"nibble {name}: not the int8 launch's bits")
        o, sub = outs[1], mirror_sub(g4, col, hh, precise)
        keep(f"band_spmm{m}_nib", cmp(f"nibble K1{m}", o[f"band_spmm{m}"],
                                      bk.spmm_band_plain(g4, row, col, hh, sub, precise)))
        keep(f"band_sage{m}_nib", cmp(f"nibble K2{m}", o[f"band_sage{m}"],
                                      bk.sage_step_plain(g4, row, col, hh, sub, aw, bw,
                                                         precise)))
        keep(f"band_halo{m}_nib", cmp(f"nibble K3{m}", o[f"band_halo{m}"],
                                      bk.spmm_band_plain(g4, row, col, hh, sub, precise)))
        keep(f"band_sage_bf16epi{m}_nib", compare_epi(
            f"nibble K2 bf16 epilogue{m}", o[f"band_sage_bf16epi{m}"],
            bk.sage_step_plain(g4, row, col, hh, sub, aw, bw, precise, f32_epi=False)))
        if precise:
            ref = bk.spmm_band_plain(g4, col, row, gh, mirror_sub(g4, row, gh))
            keep("band_spmm_bwd_nib", compare("nibble K1 backward", o["band_spmm_bwd"], ref))
            keep("band_spmm_bwd_nib", compare("nibble BandSpmm backward",
                                              o["band_spmm_bwd_autograd"], ref))
            keep("band_halo_bwd_nib", compare("nibble K3 backward", o["band_halo_bwd"], ref))
        sub8 = mirror_sub(g8, col, hh, precise)
        keep(f"band_sage_bf16epi{m}", compare_epi(
            f"K2 bf16 epilogue{m}", bk.sage_step(g8, row, col, hh, sub8, aw, bw, precise,
                                                 f32_epi=False),
            bk.sage_step_plain(g8, row, col, hh, sub8, aw, bw, precise, f32_epi=False)))

    dbg = synth_banded(n, True, 1, device).dbg0
    h, live = operands(dbg, 64, 2, device)
    row, col = scales(dbg, 7, device)
    for precise in (True, False):
        sub = mirror_sub(dbg, col, h, precise)
        for d in DIAG_NAMES:
            if device == "cpu" and d in ("noh", "hlin"):
                continue   # no plain version: the wrapper refuses them on the CPU
            got = bk.spmm_band(dbg, row, col, h, sub, precise=precise, diag=d)
            keep(f"band_spmm{'' if precise else '_bf16'}_diag_{d}", compare(
                f"K1 diag={d} precise={precise}", got,
                diag_reference(dbg, row, col, h, sub, d, precise)))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(0, 3, (64, 256, 512), generator=gen, device=device, dtype=torch.int8)
    for extra in (False, True):
        name = "stream_sum_extra" if extra else "stream_sum"
        err = (stream_sum(x, 8, extra) - stream_sum_plain(x, 8, extra)).abs().max().item()
        log(f"check {name}: max abs difference {err}")
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        keep(name, err)
    return errs


def yardstick(dbg, h, col, dtype):
    """ms of the library yardstick: torch.bmm of the widened base against
    the materialised col ⊙ h windows, in `dtype`."""
    import torch

    from mdcommunity_tpu_torch.ops.band_kernels import _windows

    base = widened(dbg, dtype)
    win = _windows((h.float() * col[:, None]).to(dtype), dbg.n_blocks, dbg.S,
                   dbg.B).contiguous()
    ms = time_ms(lambda: torch.bmm(base, win))
    del base, win
    return ms


def time_epi_kernels(device, banded, label):
    """K2's bf16 epilogue in its three modes at D = 64 on layer 0 of `banded`
    (spill-free) beside its bound (K2's), its plain version and the library
    yardstick, after a check at these shapes.  Returns numbers by counter."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    aw, bw = sage_weights(device)
    lib = {dt: yardstick(dbg, h, live, dt) for dt in (torch.float32, torch.bfloat16)}
    res, nib = {}, "_nib" if dbg.nibble else ""
    for name, precise, store in EPI_MODES:
        hh = h.to(getattr(torch, store)).contiguous()
        sub = mirror_sub(dbg, live, hh, precise)

        def kern():
            return bk.sage_step(dbg, live, live, hh, sub, aw, bw, precise, f32_epi=False)

        def plain():
            return bk.sage_step_plain(dbg, live, live, hh, sub, aw, bw, precise, False)

        err = compare_epi(f"{label} {name + nib}", kern(), plain())
        bound_ms, bound_by = bounds(dbg, 64, True, 2 if store == "bfloat16" else 4,
                                    PEAK_F32_S if precise else PEAK_BF16_S,
                                    epi_rate=PEAK_BF16_S)
        res[name + nib] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                               bound_by=bound_by, max_abs_err=err,
                               library_ms=lib[torch.float32 if precise else torch.bfloat16])
        log(f"time {label} {name + nib}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(res[name + nib]))
    return res


def diag_bounds(dbg, D, diag, precise):
    """Least time of K1's timing variant on these inputs: the bytes its
    output depends on, over the memory rate (noscale: the band, h, the
    mirror table and slot map; nodot: h and both scales, no band; noh: the
    row scale, the mirror table and slot map; hlin: the band's window
    columns [B, B + S), h, both scales, the mirror table and slot map; each
    the output too), and the band's multiply-adds it does (hlin: those of
    those columns) at the FP32 or bf16 tensor-core rate.  The bytes a
    variant stages beyond these (the band of nodot and noh) count in no
    bound.  Returns (ms, bound_by)."""
    from mdcommunity_tpu_torch.ops.dense_band import band_rows

    nb, S, B, pad_n, C = dbg.n_blocks, dbg.S, dbg.B, dbg.pad_n, dbg.C
    half = 2 if dbg.nibble else 1
    band = band_rows(dbg)
    hb, vec, mir = pad_n * D * 4, pad_n * 4, nb * C * D * 4 + pad_n * 4
    full, own = nb * S * dbg.W2 // half, nb * S * S // half
    byts = hb + {"noscale": full + hb + mir, "nodot": hb + 2 * vec,
                 "noh": vec + mir, "hlin": own + hb + 2 * vec + mir}[diag]
    nnz = 0 if diag in ("nodot", "noh") else int(
        (band[:, :, B:B + S] if diag == "hlin" else band).ne(0).sum().item())
    t_b = byts / PEAK_BYTES_S
    t_o = 2 * nnz * D / (PEAK_F32_S if precise else PEAK_BF16_S)
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def time_diag_kernels(device, banded, label):
    """K1's four timing variants in the f32 and bf16 modes at D = 64 on
    layer 0 of `banded`, beside their bounds (diag_bounds), their references
    (diag_reference) and, for noscale (the unscaled operator), the library
    yardstick.  noh and hlin need the card.  Returns numbers by counter."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    ones = torch.ones_like(live)
    res = {}
    for precise in (True, False):
        sub = mirror_sub(dbg, live, h, precise)
        lib = yardstick(dbg, h, ones, torch.float32 if precise else torch.bfloat16)
        for d in DIAG_NAMES:
            if device == "cpu" and d in ("noh", "hlin"):
                continue

            def kern(d=d):
                return bk.spmm_band(dbg, live, live, h, sub, precise=precise, diag=d)

            def plain(d=d):
                return diag_reference(dbg, live, live, h, sub, d, precise)

            name = f"band_spmm{'' if precise else '_bf16'}_diag_{d}"
            err = compare(f"{label} {name}", kern(), plain())
            bound_ms, bound_by = diag_bounds(dbg, 64, d, precise)
            res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=err,
                             library_ms=lib if d == "noscale" else None)
            log(f"time {label} {name}: pad_n={dbg.pad_n} C={dbg.C} " + json.dumps(res[name]))
    return res


def time_stream(device, banded, label, G=8):
    """The stream probe over layer 0's stored base [nb, S+C, W2] in groups
    of G blocks, with and without the masked reductions, beside its bound
    (the base read once), its plain version and, without them, the library
    call torch.sum(..., dtype=float32) of the same groups.  Returns numbers
    by counter."""
    import torch

    from mdcommunity_tpu_torch.ops.probe_kernels import stream_sum, stream_sum_plain

    x = banded.dbg0.base
    x = x[: x.shape[0] // G * G]
    flat = x.view(x.shape[0] // G, -1)
    res = {}
    for extra in (False, True):
        name = "stream_sum_extra" if extra else "stream_sum"
        err = (stream_sum(x, G, extra) - stream_sum_plain(x, G, extra)).abs().max().item()
        if err != 0:
            raise AssertionError(f"{label} {name}: kernel disagrees with its plain version")
        res[name] = dict(
            ms=time_ms(lambda: stream_sum(x, G, extra)),
            plain_ms=time_ms(lambda: stream_sum_plain(x, G, extra)),
            bound_ms=1e3 * x.numel() / PEAK_BYTES_S, bound_by="bytes", max_abs_err=err,
            library_ms=None if extra else time_ms(
                lambda: torch.sum(flat, dim=1, dtype=torch.float32)))
        log(f"time {label} {name}: shape={list(x.shape)} G={G} " + json.dumps(res[name]))
    return res


def time_slice6(device, banded, nib, nib_clean, label):
    """This slice's modes at `banded`'s shapes: K2's bf16 epilogue, K1's diag
    variants and the stream probe on `banded`; K1, K1's backward, K2 with
    either epilogue and their bf16 modes on the nibble build `nib`, and K3
    on the spill-free nibble build `nib_clean` (synth_banded(nibble=True)).
    Returns numbers by counter."""
    import torch

    res = time_epi_kernels(device, banded, label)
    res.update(time_diag_kernels(device, banded, label))
    res.update(time_stream(device, banded, label))
    res.update(time_kernels(device, nib, label))
    res.update(time_bf16_kernels(device, nib, label))
    res.update(time_epi_kernels(device, nib, label))
    res.update(time_halo_kernels(device, nib_clean, label))
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


def probe_phase(device, small=False):
    """The slice's path: the four probe entry points through their mains,
    probe_f32_epi at 18,222 nodes and bench_nibble, tune_band --diag and
    probe_hbm_roof at 2^20 (few repetitions), every launch count set to 0
    just before and read just after.  small: the CPU rehearsal's sizes.
    Returns the counts."""
    from mdcommunity_tpu_torch import bench_nibble, probe_f32_epi, probe_hbm_roof, tune_band

    import torch

    quick = ["--reps", "3", "--warm", "1"]
    if small:
        quick += ["--device", "cpu"]
    runs = [
        (probe_f32_epi, ["--n", "2048"] if small else []),
        (bench_nibble, ["--n-check", "4096", "--n", "4096"] if small else []),
        (tune_band, ["--diag"] + (["--n", "4096"] if small else [])),
        (probe_hbm_roof, ["--n", "4096"] if small else []),
    ]
    reset_all_launches()
    t0 = time.perf_counter()
    for probe, argv in runs:
        t1 = time.perf_counter()
        probe.main(argv + quick)
        log(f"probe {probe.__name__.rsplit('.', 1)[1]}: {time.perf_counter() - t1:.1f} s")
    counts = all_launches()
    log(f"probe phase: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    if device != "cpu":
        torch.cuda.empty_cache()
    return counts


# (counter, file:line of the TPU kernel code it replaces, mode) of this
# slice's modes on the kernels line
SLICE6 = [(f"{k}{mode_suffix(p, s)}_nib", "mdcommunity_tpu/ops/band_pallas.py:584",
           f"nibble=True (:584-602){'' if p else ', precise=False, ' + s + ' storage'}"
           + extra)
          for k, extra in (("band_spmm", ""), ("band_sage", ", sage=True"),
                           ("band_sage_bf16epi", ", sage=True, f32_epi=False"),
                           ("band_halo", ", halo=True"))
          for p, s in PREC_MODES]
SLICE6 += [(name, "mdcommunity_tpu/ops/band_pallas.py:584", mode) for name, mode in (
    ("band_spmm_bwd_nib", "nibble=True, the VJP with row and col swapped (:811-829)"),
    ("band_halo_bwd_nib", "nibble=True, halo=True, the VJP (band_partition.py:312-327)"))]
SLICE6 += [(name, "mdcommunity_tpu/ops/band_pallas.py:653",
            "sage=True, f32_epi=False (:653-668)" + ("" if p else f", precise=False, {s} storage"))
           for name, p, s in EPI_MODES]
SLICE6 += [(f"band_spmm{'' if p else '_bf16'}_diag_{d}", "mdcommunity_tpu/ops/band_pallas.py:280",
            f"diag={d!r} (:280-286){'' if p else ', precise=False'}")
           for p in (True, False) for d in DIAG_NAMES]
SLICE6 += [("stream_sum", "scripts/probe_pallas_stream.py:20", "make_stream"),
           ("stream_sum_extra", "scripts/probe_overlap.py:51", "make(extra_compute=True)")]


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
    from mdcommunity_tpu_torch.utils.timing import gpu_line

    set_precise_matmul()
    if args.rehearse:
        from mdcommunity_tpu_torch.native import build as native_build

        native_build.build()
        check_kernels("cpu", 2048)
        check_bf16_kernels("cpu", 2048)
        check_backward("cpu", 2048)
        time_kernels("cpu", synth_banded(2048, True, 0, "cpu"), "rehearsal")
        time_bf16_kernels("cpu", synth_banded(2048, True, 0, "cpu"), "rehearsal")
        check_blocked("cpu")
        small_bd = blocked_graph(2048, "cpu", max_rank=0)
        time_blocked("cpu", small_bd, "rehearsal")
        check_blocked_backward("cpu", small_bd)
        result = main_path("cpu", 2048, 0.01)[1]
        fast_main_path("cpu", 5000, 0.01, result)  # above the small-graph threshold
        fast_forward_phase("cpu", 2048)
        check_fit("cpu", 2048)
        small, edges = synth_banded(2048, False, 0, "cpu", reorder=False, with_edges=True)
        trainer_phase("cpu", small, edges, 16)
        fit_memory("cpu", small, 16)
        small_graph_phase("cpu")
        bd, net = blocked_phase("cpu", 2048, 4, 40)[:2]
        blocked_gradient_phase(bd, net)
        for gp in (2, 4):
            check_halo_kernels("cpu", 2048, gp)
            time_halo_kernels("cpu", small, "rehearsal", gp)
            sharded_forward_phase("cpu", small, gp)
            sharded_trainer_phase("cpu", small, edges, 16, gp)
        check_slice6_kernels("cpu", 2048)
        time_slice6("cpu", synth_banded(2048, True, 0, "cpu"),
                    synth_banded(2048, True, 0, "cpu", nibble=True),
                    synth_banded(2048, False, 0, "cpu", reorder=False, nibble=True), "rehearsal")
        probe_phase("cpu", small=True)
        log("rehearsal done")
        return 0
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs one GPU")
    device = "cuda"
    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_all()
    errs = check_kernels(device, 1 << 16)
    errs.update(check_bf16_kernels(device, 1 << 16))
    errs["band_spmm_bwd"] = check_backward(device, 1 << 16)
    errs.update(check_halo_kernels(device, 1 << 16))
    errs.update(check_slice6_kernels(device, 1 << 16))

    main_graph = synth_banded(18222, True, 0, device)
    times = time_kernels(device, main_graph, "18,432 rows")
    times.update(time_bf16_kernels(device, main_graph, "18,432 rows"))
    # the sharded engine refuses spill: the unshuffled build
    clean18 = synth_banded(18222, False, 0, device)
    times.update(time_halo_kernels(device, clean18, "18,432 rows"))
    times.update(time_slice6(device, main_graph, synth_banded(18222, True, 0, device, nibble=True),
                             synth_banded(18222, False, 0, device, nibble=True), "18,432 rows"))
    del main_graph, clean18
    big, big_edges = synth_banded(1 << 20, False, 0, device, reorder=False,
                                  with_edges=True)
    time_kernels(device, big, "2^20 rows")
    time_bf16_kernels(device, big, "2^20 rows")
    big_nib = synth_banded(1 << 20, False, 0, device, reorder=False, simple=True, nibble=True)
    time_slice6(device, big, big_nib, big_nib, "2^20 rows")
    del big_nib
    torch.cuda.empty_cache()
    blocked_errs, blocked_times = blocked_kernel_phases(device)

    counts, result = main_path(device, 18222, 0.001)
    for k in ("band_spmm", "band_sage"):
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"main path AUDC {result['audc']:.6f} after {result['removed']} removals")
    fast_counts = fast_main_path(device, 18222, 0.001, result)[0]
    fwd_counts = fast_forward_phase(device, 18222)
    fast_counts = {k: fast_counts[k] + fwd_counts[k] for k in fast_counts}
    for name, _, _ in BF16_MODES:
        if fast_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the fast path")

    fit_err = check_fit(device, 18222)
    train_counts = trainer_phase(device, big, big_edges, 1048)
    fit_memory(device, big, 1048)
    time_halo_kernels(device, big, "2^20 rows")
    halo_counts = sharded_forward_phase(device, big)
    shard_train_counts = sharded_trainer_phase(device, big, big_edges, 1048)
    halo_counts = {k: halo_counts[k] + shard_train_counts[k] for k in halo_counts}
    for name in ("band_halo", "band_halo_bf16", "band_halo_bf16_act", "band_halo_bwd"):
        if halo_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the sharded path")
    del big
    torch.cuda.empty_cache()

    probe_counts = probe_phase(device)
    for name, _, _ in SLICE6:
        if probe_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the probes' path")

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
    for name, kernel, store in BF16_MODES:
        t = dict(times[name])
        t["max_abs_err"] = max(errs[name], t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/band.cu",
            replaces="mdcommunity_tpu/ops/band_pallas.py:259",
            mode=f"precise=False, {store} storage", launches=fast_counts[name], **t))
    for name, precise, store in HALO_MODES + (("band_halo_bwd", True, "float32"),):
        t = dict(times[name])
        t["max_abs_err"] = max(errs[name], t["max_abs_err"])
        mode = ("halo=True (:274-278)" + ("" if precise else f", precise=False, {store} storage")
                + (", the VJP with row and col swapped (band_partition.py:312-327)"
                   if name == "band_halo_bwd" else ""))
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/band.cu",
            replaces="mdcommunity_tpu/ops/band_pallas.py:259", mode=mode,
            launches=halo_counts[name], **t))
    for name, replaces, mode in SLICE6:
        t = dict(times[name])
        t["max_abs_err"] = max(errs.get(name, 0.0), t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda",
            source="mdcommunity_tpu_torch/csrc/"
                   + ("probe.cu" if name.startswith("stream") else "band.cu"),
            replaces=replaces, mode=mode, launches=probe_counts[name], **t))
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
