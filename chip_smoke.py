#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mdcommunity_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on any failure:
  1. build the band kernels (nvcc, sm_90a) and the native host engine (g++)
     from the checkout's sources, in parallel, while the host makes the
     variants' structures (phase 12's Louvain);
  2. check kernels K1 (band_spmm, D=64 and D=2) and K2 (band_sage) against
     their plain PyTorch versions on the card, on seeded banded graphs of
     2^16 nodes with live mirror lanes (and, for K2, no spill), and K1's
     backward (band_spmm_bwd: torch.autograd.grad through BandSpmm, row !=
     col) against autograd through the plain operator; and K1's and K2's
     bf16 modes (precise=False), h stored in f32 and in bf16, each launched
     twice for bit-identical output; the precise K1 (D = 64 and 2), K1's
     backward, K2 with either epilogue and K3 (and its backward) also
     against their plain versions run in float64 on the same inputs, within
     F64_TOL of max|ref| (check_f64, which logs the f32 plain version's
     error beside the kernel's); and K1, K2 (either epilogue) and K3 in the
     precise and both bf16 modes at the edges of their chunk geometry
     (check_edges: (S, B), D, one- and two-block rings, an all-zero band
     block, rows that reach both window ends; int8 and nibble; relaunched
     for the same bits, nibble = int8 and sharded = K1 bit for bit; the
     precise ones against f64 too), and split over CTAs of fewer rows at
     18,432 rows against whole-block CTAs, bit for bit (check_split);
  3. time K1, K2, K1's backward, the bf16 modes, their plain versions and a
     library yardstick (torch.bmm of the widened band against materialised
     windows, in bf16 for the bf16 modes) at the main path's shapes, 18,432
     rows with D=64, each beside its bound; then hold the same kernels (and
     phase 9's int8 modes: K2's bf16 epilogue, the diag variants, the
     stream probe) against their plain versions at 2^20 rows, the shapes
     the training paths give them, untimed (their 2^20-row times are
     mdcommunity_tpu_torch/time_band_rows.py's);
  4. drive the main path: large-graph greedy dismantling of the 18,222-node
     shuffled synthetic duplex of `large_graph_demo --sizes 18222` by the
     committed unit-cost checkpoint, through eval.real.evaluate_real
     (StepRatio 0.001, one host cascade per batch, native host engine), with
     every kernel's launch count set to 0 just before and read just after;
     its first forward is held against the same forward on the CPU, and its
     own rollout against the CPU's forward (plain versions) through the
     rollout's shadow (Lockstep) for the first LOCKSTEP_CALLS model calls
     or up to the first call whose top-k differs, which must be a near-tie
     (TIE); then
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
  7. check K4 and K5 against their plain versions (a random layout; an
     edge layout with T % 32 != 0, a hub row, dead rows, D = 2, 30, 64,
     160, 300 and misaligned operands; two launches bit-equal) and time
     them (CUDA events and profiler device time), run the small-graph
     validation and golden synthetic rows, and the 18,222-node blocked
     dismantling against the segment engine with one blocked gradient;
  8. the gp-sharded band engine, GP = 4 shards on the one card: K3 (the
     halo-mode band kernel, band_halo) in its three modes against its plain
     version on two 2^16-row graphs (interior and boundary launches, and
     one launch a shard), the sharded operator and its backward against K1
     and BandSpmm on the whole graph (max abs difference 0); K3's times at
     18,432 and 2^20 rows beside K1's; the sharded model call at 2^20 nodes,
     precise and fast, against the unsharded one (precise: bit for bit, the
     dense layers running over utils/device.row_matmul's row chunks, with
     the GEMM kernels cuBLAS picks at a shard's and the whole graph's rows
     logged; fast within FAST_Q_TOL); and 6 iterations of the
     sharded trainer loop at 2^20 beside the unsharded loop (the same
     removals), counts set to 0 just before and read just after;
  9. the band kernel's last TPU modes and the stream probe: nibble storage
     against int8 (max abs difference 0) in K1, K1's backward, K2 with
     either epilogue and K3 in the three modes after a batch of severs with
     duplicates and both cells of one byte, and against the plain versions;
     K2's bf16 epilogue (f32_epi=False) within EPI_TOL of its plain version;
     K1's diag variants (noscale, nodot, noh, hlin; f32 and bf16) against
     their references; the stream probe (probe.cu) exactly; their times at
     18,432 rows beside bound, plain and library, and the same checks again
     at 2^20 rows (untimed: those times are time_band_rows.py's); then the
     slice's path, the four probe entry points through their mains
     (probe_f32_epi at 18,222 nodes, bench_nibble timed at 2^18, tune_band
     --diag and probe_hbm_roof at 2^20), counts set to 0 just before and
     read just after;
 10. the bf16 fit: K1's bf16 mode with the scales swapped (BandSpmm's
     backward at precise=False) against its plain version at 18,432 rows,
     the sharded bf16 gradient against the unsharded one (max abs
     difference 0), both backward launches timed at 18,432 rows (K3's also
     at 2^20; K1's held to its plain version there, untimed),
     and train_banded_loop(precise=False) at 2^20 nodes, unsharded and at
     GP = 4, beside the precise loop's fit ms, counts set to 0 just before
     and read just after;
 11. the small-graph DQN trainer at Config()'s full width: DQNAgent.train
     for DQN_ITERS iterations (warm-up, play, validation, fit rate, VCs,
     peak memory), a resume from latest.ckpt, and one train_step on the
     card against the CPU's;
 12. the variants (variant_phase): degree cost, CE and HCA, each with its
     committed *_100k_r5 checkpoint, dismantling the main path's graph
     through evaluate_real(variant=...) (the CE prior and the HCA
     communities by the port's Louvain; HCA's pooling on K1, its community
     pass on csrc/hca.cu, whose launches the HCA run must show and K1's
     one-hot launches must not), each first forward on the card held to the
     CPU's, precise and fast (at the fast rows' tolerances, CE's less the
     shift common to all its nodes; HCA relaunched for the same bits), the
     first VARIANT_LOCKSTEP model calls of each run held to the CPU forward
     (Lockstep), counts set to 0 just before and read just after each run;
     K1 at the community widths (D = 128, 256 and a 512-wide K1 form in two
     launches, in both precise modes; bit-equal on one-hot operands,
     relaunched for the same bits); the community pass at c_pad = 512
     bit-equal to that K1 form, the CPU's plain pass and a relaunch, and
     timed at the HCA path's c_pad and at 2^20 rows with c_pad 4,096 beside
     its bound and plain version; and each variant's synthetic rows (sizes 32, 64, 128) and
     32-graph validation VC on the card against the CPU (identical rows,
     VCs within 1e-4);
 13. the variants' training (variant_train_phase): DQNAgent for CE and for
     HCA at Config()'s full width for VT_ITERS iterations each (VCs, fit
     iterations a second, peak memory, CE's LMCC-DEBUG and CE-PRIOR lines),
     a resume of each from latest.ckpt, one train_step of each on the card
     against the CPU by tests/gradient_rules.py (CE as unit cost, its gate
     leaves also to their terms; HCA per gradient leaf against the CPU's
     float64 referee),
     one eps = 0 rollout chunk of each, with CE's pruning and HCA's bridge
     reward, on the card against the CPU (the same actions and rewards up
     to a near-tie parting); train_banded_loop(variant="degree_cost") at
     2^20 nodes (degree weights on the spill-free build) and
     variant="ce" on the main path's graph with its prior, VT_BANDED_ITERS
     iterations each (K1, K2 and K1's backward counted; the first fit's loss
     on the card against the CPU's plain loss on the same state, within
     1e-5 of the loss's terms, with a bf16 and a TF32 control that must
     fall outside that bound), degree cost at GP = 4 for 3 iterations beside the unsharded
     loop (K3 and its backward counted), and live_scales(mean|gcn) on the
     main path's graph, K1 at D = 1 in both precise modes, bit-equal to its
     plain version; counts set to 0 just before each path and read just
     after;
 14. the heuristic baselines and the remaining eval tools (baselines_phase;
     no kernel of its own): the degree_max2 and ci_max2 rows of golden.json
     on the card (rtol 1e-5); all five methods x both combines, plain, with
     protect_frac = 0.05 and with the _syn stop, at 64 nodes on 2 graphs,
     the card's solutions and scores identical to the CPU's; `cli baseline`
     for degree and CI at 1,024 nodes (2 graphs) on the card and with
     --cpu, identical lines, the seconds a graph logged; analyze on those
     runs' time&audc files, summarize-edges on a written .edges file, draw
     (a PNG, or where matplotlib is absent an ImportError naming it);
     model_vs_heuristics at 64 nodes, 3 graphs, card rows = CPU rows;
     ops/band_spmm.spmm_band on layer 0 of the main path's graph in its
     locality order (S = 512, B = 256, D = 64, a non-empty overflow): the
     forward and the gradients of the band weights, the overflow weights and
     h within SPMM_BAND_TOL of max|ref| of float64 on the CPU, two calls
     bit-equal, fwd+bwd ms beside BandSpmm's (K1) on the same graph; and
     parallel/partition.spmm_edge_partitioned at GP = 4 on the 2^20-node
     unshuffled graph within PARTITION_TOL of max|ref| of the unsharded
     segment sum, two calls bit-equal, with its ms;
 15. the port across processes (multiprocess_phase): two OS processes
     (mdcommunity_tpu_torch.multihost_smoke's children, gloo, both on the
     one card, gp = 4 with two shards a process) on a spill-free 2^18-node
     build: the sharded operator and its VJP in both precise modes, Q
     precise and fast, the loss and its gradients, 3 iterations of
     train_banded_loop(mesh=), DQNAgent(mesh=dp 2)'s fits and validation
     and the edge partition, each against the one-process run (Q against
     the unsharded forward bit for bit in the precise mode; the gradients
     of the cross-process and of the one-process loss against the same
     loss in float64 on the CPU), with K3's launches counted in each child,
     and the cross-process model call's ms beside the one-process call's
     and its halo exchange's;
 16. the measurement tools (tools_phase), each through its main, counts
     set to 0 just before and read just after: bench_spmm (bench.py's SpMM
     fwd+bwd edges/s, K1's bf16 mode and precise mode both ways, on phase
     9's 2^20 ring build; its step first held against K1's plain versions
     at 18,432 rows), scaling_bench (both gp engines at gp = 1, 2, 4 on the
     one card: band bit-equal across gp, edge partition within 1e-6),
     bench_cascade_host (20 batches of the native cascade at 2^20 nodes)
     and bf16_ab_train (the f32 and TF32 arms, 20 iterations); their four
     JSON lines are printed before the card's line.
Prints the card's name and power limit, a `kernels` JSON line, and as its
last line {"ok": true, "device": {...}}.  Needs one CUDA card; without one it
exits non-zero and prints no result.  --rehearse runs every phase at a small
size on the CPU with the plain versions (no counts, no result line).
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import shutil
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
LOCKSTEP_CALLS = 100     # main-path model calls held to the CPU's trajectory
# the sharded precise forward vs the unsharded one, of max|Q|: 0.  K3 gives
# K1's bits, the graph-wide sums add the shards' partials in shard order,
# and every node-row product runs over utils/device.row_matmul's fixed row
# chunks, so a shard's dense layers issue the very GEMMs the whole graph's
# do (cuBLAS picks its f32 kernel by the row count: sharded_forward_phase
# logs the kernels at a shard's and at the whole graph's rows)
SHARD_Q_TOL = 0.0
BLOCKED_STEPS = 180      # removals of the blocked path's run (step 18): 10 model calls
GOLDEN_VC = 0.1194451824  # tests/test_golden_models.py, unit cost, 32 graphs
GOLDEN_SYN = os.path.join(HERE, "results_tpu", "golden_synthetic", "golden.json")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- build


def build_all():
    from mdcommunity_tpu_torch.native import build as native_build
    from mdcommunity_tpu_torch.ops import (
        band_kernels,
        blocked_kernels,
        cascade_kernels,
        hca_kernels,
        probe_kernels,
    )

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
        threading.Thread(target=run, args=("cascade.cu (nvcc)", cascade_kernels.build)),
        threading.Thread(target=run, args=("hca.cu (nvcc)", hca_kernels.build)),
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
    for name in ("band", "blocked", "probe", "cascade", "hca"):
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


@functools.lru_cache(maxsize=None)
def check_graph_a(n, device):
    """The kernel checks' graph A, synth_banded(n, True, 1): shuffled, so
    its band has mirror lanes and spill.  Built once (the host's reordering
    takes seconds) and shared by the checks, which only read it."""
    return synth_banded(n, True, 1, device)


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


def compare(name, got, ref, quiet=False):
    import torch

    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = err / max(scale, 1e-30)
    if not quiet:
        log(f"check {name}: max_abs_err {err:.3e}  max|ref| {scale:.3e}  rel {rel:.3e}")
    if not torch.isfinite(got).all() or rel > REL_TOL:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def check_kernels(device, n):
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    import torch

    errs = {}
    mirrored = check_graph_a(n, device)
    dbg = mirrored.dbg0
    log(f"check graph A: n={n} C={dbg.C} spill={dbg.spill.nnz}")
    if not dbg.C:
        raise AssertionError("check graph A has no mirror lanes")
    h, live = operands(dbg, 64, 2, device)
    sub = mirror_sub(dbg, live, h)
    got, ref = bk.spmm_band(dbg, live, live, h, sub), bk.spmm_band_plain(dbg, live, live, h, sub)
    errs["band_spmm"] = compare("K1 D=64", got, ref)
    check_f64("K1 D=64", got, bk.spmm_band_plain(dbg, *f64(live, live, h, sub)), ref,
              counter="band_spmm")
    h2, ones = operands(dbg, 2, 3, device, unit=True)
    sub2 = mirror_sub(dbg, ones, h2)
    got, ref = (bk.spmm_band(dbg, ones, ones, h2, sub2),
                bk.spmm_band_plain(dbg, ones, ones, h2, sub2))
    errs["band_spmm"] = max(errs["band_spmm"], compare("K1 D=2", got, ref))
    check_f64("K1 D=2", got, bk.spmm_band_plain(dbg, *f64(ones, ones, h2, sub2)), ref,
              counter="band_spmm")

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
    ref64 = f64_calls(dbg, live, live, h, sub, aw, bw)
    for name, f32_epi in (("band_sage", True), ("band_sage_bf16epi", False)):
        got = bk.sage_step(dbg, live, live, h, sub, aw, bw, f32_epi=f32_epi)
        ref = bk.sage_step_plain(dbg, live, live, h, sub, aw, bw, f32_epi=f32_epi)
        errs[name] = (compare if f32_epi else compare_epi)(f"K2 f32_epi={f32_epi}", got, ref)
        check_f64(f"K2 f32_epi={f32_epi}", got, ref64[name][0], ref, ref64[name][1],
                  counter=name)
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


def device_time_ms(fn):
    """Mean device ms of one call of fn, its kernels' own time summed
    (utils/timing.device_ms: torch.profiler over 20 calls), without the host
    work that time_ms's event pair also holds.  NaN in the CPU rehearsal."""
    import torch

    from mdcommunity_tpu_torch.utils.timing import device_ms

    if torch.cuda.is_available():
        return device_ms(fn)
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


def time_kernels(device, banded, label, timed=True):
    """K1 (D = 64 and the degree pass's D = 2), K2 and K1's backward on
    layer 0 of `banded` against their plain versions, then (timed) each
    beside its bound, its plain version and the library yardstick.  Returns
    the numbers by counter (timed=False: the errors only)."""
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.band_kernels import _windows
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    import torch

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    sub = mirror_sub(dbg, live, h)
    aw, bw = sage_weights(device)
    # the kernels against their plain versions at these shapes, the degree
    # pass (D = 2, unit scales) included
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
    nib = "_nib" if dbg.nibble else ""
    if not timed:
        return {k + nib: dict(max_abs_err=v) for k, v in errs.items()}
    lib = {}
    for key, x, scale in (("fwd", h, live), ("bwd", g, row)):
        base_f = widened(dbg, torch.float32)
        win = _windows(x * scale[:, None], dbg.n_blocks, dbg.S, dbg.B).contiguous()
        lib[key] = time_ms(lambda: torch.bmm(base_f, win))
        del base_f, win
    lib_ms, lib_bwd_ms = lib["fwd"], lib["bwd"]
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


def compare_bf16(name, got, ref, quiet=False):
    """A bf16-storage output against its plain version: within one bf16 ulp
    of each element (the f32 sums before the rounding run in another order)
    plus REL_TOL of max|ref|."""
    import torch

    got, ref = got.float(), ref.float()
    scale = ref.abs().max().item()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    excess = ((got - ref).abs() - ulp - REL_TOL * scale).max().item()
    err = (got - ref).abs().max().item()
    if not quiet:
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
    dbg = check_graph_a(n, device).dbg0
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


def time_bf16_kernels(device, banded, label, timed=True):
    """Each bf16 mode at D = 64 beside its bound, its plain version and the
    library yardstick (torch.bmm of the bf16-widened band against
    materialised bf16(col ⊙ h) windows), after a check at these shapes.
    Also logs the time of the dense formulation the kernel runs, 2·rows·W2·D
    at the bf16 rate.  timed=False: the checks only (and the backward's,
    time_bf16_backward), their errors by counter."""
    import torch

    from mdcommunity_tpu_torch.ops.band_kernels import _windows

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    aw, bw = sage_weights(device)
    res, nib = {}, "_nib" if dbg.nibble else ""
    errs = {name: check_bf16_mode(label, name, *bf16_mode_fns(dbg, live, h, aw, bw, kernel,
                                                               store))
            for name, kernel, store in BF16_MODES}
    if not timed:
        res = {name + nib: dict(max_abs_err=err) for name, err in errs.items()}
        res.update(time_bf16_backward(device, dbg, label, timed=False))
        return res
    base_b = widened(dbg, torch.bfloat16)
    win = _windows((h * live[:, None]).to(torch.bfloat16), dbg.n_blocks, dbg.S,
                   dbg.B).contiguous()
    lib_ms = time_ms(lambda: torch.bmm(base_b, win))
    del base_b, win
    for name, kernel, store in BF16_MODES:
        kern, plain = bf16_mode_fns(dbg, live, h, aw, bw, kernel, store)
        err = errs[name]
        bound_ms, bound_by = bounds(dbg, 64, kernel == "sage",
                                    2 if store == "bfloat16" else 4, PEAK_BF16_S)
        res[name + nib] = dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
                               max_abs_err=err)
        dense_ms = 1e3 * 2 * dbg.pad_n * dbg.W2 * 64 / PEAK_BF16_S
        log(f"time {label} {name + nib}: pad_n={dbg.pad_n} C={dbg.C} "
            + json.dumps(dict(res[name + nib], dense_formulation_ms=dense_ms)))
    res.update(time_bf16_backward(device, dbg, label))
    return res


def time_bf16_backward(device, dbg, label, timed=True):
    """The bf16 fit's backward launch, K1's bf16 mode with row and col
    swapped on a cotangent g (band_spmm_bf16_bwd, f32 storage), at D = 64
    beside its bound, its plain version, the library yardstick (torch.bmm of
    the bf16-widened band against materialised bf16(row ⊙ g) windows) and
    its device time (utils/timing.device_ms), after a check at these
    shapes (timed=False: the check only)."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.band_kernels import _windows
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    name = "band_spmm_bf16_bwd" + ("_nib" if dbg.nibble else "")
    row, col = scales(dbg, 9, device)
    g = torch.nn.functional.normalize(operands(dbg, 64, 10, device)[0], dim=-1)
    sub_g = mirror_sub(dbg, row, g, precise=False)

    def kern():
        return bk.spmm_band(dbg, col, row, g, sub_g, "band_spmm_bf16_bwd", precise=False)

    def plain():
        return bk.spmm_band_plain(dbg, col, row, g, sub_g, precise=False)

    err = check_bf16_mode(label, name, kern, plain)
    if not timed:
        return {name: dict(max_abs_err=err)}
    base_b = widened(dbg, torch.bfloat16)
    win = _windows((g * row[:, None]).to(torch.bfloat16), dbg.n_blocks, dbg.S,
                   dbg.B).contiguous()
    lib_ms = time_ms(lambda: torch.bmm(base_b, win))
    del base_b, win
    bound_ms, bound_by = bounds(dbg, 64, False, 4, PEAK_BF16_S)
    row_ = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms, max_abs_err=err,
                device_ms=device_time_ms(kern))
    log(f"time {label} {name}: pad_n={dbg.pad_n} C={dbg.C} " + json.dumps(row_))
    return {name: row_}


# ---------------------------------------------------------------- the f64 yardstick

# The precise mode against its plain version run in float64 on the same
# inputs, in units of max|ref|: f32's 2^-23 with room for a few terms.  K2's
# epilogue can cancel and then normalises, which amplifies any f32 error in
# a row whose z is small against its terms (D = 2 shows it): the check holds
# the kernel on the rows that f32 resolves, those where the f32 plain version
# is within F64_TOL / 2 (all of them for K1 and K3), and logs their share.
# Each check logs the kernel's error beside the f32 plain version's and fails
# when the kernel's exceeds F64_TOL; F64 keeps the worst by counter.
F64_TOL = 1e-6
F64 = {}


def f64(*xs):
    """xs with every floating tensor in float64 (graphs and None as they are)."""
    import torch

    return [x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in xs]


def check_f64(name, got, ref64, ref32, ref64_plain=None, counter=None):
    """The kernel's output `got` [n, D] against `ref64` and the f32 plain
    version's `ref32` against `ref64_plain` (by default ref64), in units of
    max|ref64|: the kernel on the rows that f32 resolves, the plain version
    on all rows.  Raises when the kernel's exceeds F64_TOL."""
    ref64_plain = ref64 if ref64_plain is None else ref64_plain
    scale = max(ref64.abs().max().item(), 1e-300)
    e_k = (got.double() - ref64).abs().amax(-1) / scale
    e_p = (ref32.double() - ref64_plain).abs().amax(-1) / scale
    rows = e_p <= F64_TOL / 2
    kern = e_k[rows].max().item() if rows.any() else 0.0
    log(f"f64 {name}: kernel {kern:.3e} ({e_k.max().item():.3e} on every row), f32 plain "
        f"{e_p.max().item():.3e} of max|ref| {scale:.3e}; rows held "
        f"{rows.double().mean().item():.1%}")
    key = counter or name
    old = F64.get(key, (0.0, 0.0, 1.0))
    F64[key] = (max(old[0], kern), max(old[1], e_p.max().item()),
                min(old[2], rows.double().mean().item()))
    if not kern <= F64_TOL:
        raise AssertionError(f"{name}: {kern:.3e} of max|ref| from the f64 plain version")
    return kern


def bf16_epilogue64(pool, h, aw, bw):
    """K2's bf16 epilogue (f32_epi=False) in f64 on the pooled block `pool`:
    the dot operands rounded to bf16, as sage_step_plain rounds them."""
    import torch

    r = lambda x: x.to(torch.bfloat16).double()  # noqa: E731
    z = torch.relu(r(pool) @ r(aw) + r(h) @ r(bw))
    return z * torch.rsqrt(torch.clamp(torch.sum(z * z, -1, keepdim=True), min=1e-24))


def f64_calls(dbg, row, col, h, sub, aw, bw):
    """{counter: (the kernel's f64 reference, the f32 plain version's)} of
    the precise K1, K2 and K2's bf16 epilogue on these inputs: their plain
    versions in f64.  The bf16 epilogue rounds its dot operands to bf16 by
    definition, so a pooled value within f32 noise of a rounding boundary
    may round either way; its references are the f64 epilogue on the
    bf16-rounded pooled block that K1 (K2's pooled block bit for bit: the
    same contraction, mirror add and row scale) and K1's plain version
    compute on the same inputs.  K1's own check holds that block."""
    from mdcommunity_tpu_torch.ops import band_kernels as bk

    a64, w64 = f64(row, col, h, sub), f64(aw, bw)
    k1 = bk.spmm_band_plain(dbg, *a64)
    k2 = bk.sage_step_plain(dbg, *a64, *w64)
    return {"band_spmm": (k1, k1), "band_sage": (k2, k2),
            "band_sage_bf16epi": tuple(bf16_epilogue64(p, h, aw, bw) for p in (
                bk.spmm_band(dbg, row, col, h, sub), bk.spmm_band_plain(dbg, row, col, h, sub)))}


# ---------------------------------------------------------------- edge shapes

# (S, B) and D of the edge checks: the window's chunk geometry (S + 2B of
# 256, 512, 1024 and 768 columns; B = S lets every row reach both window
# ends) and the column groups (D = 2 and 24 pad to 16 and 32 columns, D = 2
# also loads h element by element)
EDGE_SB = ((128, 64), (256, 128), (512, 256), (256, 256))
EDGE_D = (2, 24, 64)


def edge_graph(kind, nb, S, B, nibble, device, seed=0):
    """A graph of nb blocks of S rows (n = nb·S) for the edge checks:
    'ring' joins each node to its next three ring neighbours and each
    block's first row to a uniform node (mirror lanes where that edge leaves
    the band, no spill); 'hollow' is the ring with block 1's nodes edgeless
    (an all-zero band block); 'ends' joins every row of block b to the first
    row of block b − 1 and the last of block b + 1, so with B = S every row
    holds entries at both ends of its window.  Simple: nibble storage takes
    it."""
    import numpy as np

    from mdcommunity_tpu_torch.ops.dense_band import build_dense_band

    n = nb * S
    i = np.arange(n)
    if kind == "ends":
        blk = i // S
        pairs = [np.stack([i, (blk - 1) % nb * S], 1), np.stack([i, (blk + 1) % nb * S + S - 1], 1)]
    else:
        rng = np.random.default_rng(seed)
        pairs = [np.stack([i, (i + k) % n], 1) for k in (1, 2, 3)]
        pairs.append(np.stack([i[::S], rng.integers(0, n, nb)], 1))
    p = np.concatenate(pairs)
    if kind == "hollow":
        p = p[(p // S != 1).all(1)]
    p = np.unique(np.sort(p[p[:, 0] != p[:, 1]], 1), axis=0)
    src, dst = np.concatenate([p[:, 0], p[:, 1]]), np.concatenate([p[:, 1], p[:, 0]])
    return build_dense_band(src, dst, n, S=S, B=B, device=device, nibble=nibble)


def mode_calls(g, row, col, h, aw, bw, mesh, precise):
    """{counter: (kernel call, plain call, compare)} of K1, K2 with either
    epilogue and the sharded operator (K3 on mesh's shards) in the precise
    (h f32) or the bf16 mode on graph g, h stored in its dtype."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub
    from mdcommunity_tpu_torch.parallel.band_partition import shard_band_graph, spmm_band_sharded
    from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, split_nodes

    m = mode_suffix(precise, "bfloat16" if h.dtype == torch.bfloat16 else "float32")
    sub = mirror_sub(g, col, h, precise=precise)
    cmp = compare_bf16 if h.dtype == torch.bfloat16 else compare
    sdbg = shard_band_graph(mesh, g)
    parts = [split_nodes(mesh, x) for x in (row, col, h)]
    k1_plain = lambda: bk.spmm_band_plain(g, row, col, h, sub, precise)  # noqa: E731
    return {
        f"band_spmm{m}": (lambda: bk.spmm_band(g, row, col, h, sub, precise=precise),
                          k1_plain, cmp),
        f"band_sage{m}": (lambda: bk.sage_step(g, row, col, h, sub, aw, bw, precise),
                          lambda: bk.sage_step_plain(g, row, col, h, sub, aw, bw, precise),
                          cmp),
        f"band_sage_bf16epi{m}": (
            lambda: bk.sage_step(g, row, col, h, sub, aw, bw, precise, f32_epi=False),
            lambda: bk.sage_step_plain(g, row, col, h, sub, aw, bw, precise, False),
            compare_epi),
        f"band_halo{m}": (
            lambda: gather_nodes(mesh, spmm_band_sharded(mesh, sdbg, *parts, precise=precise)),
            k1_plain, cmp),
    }


def check_edges(device):
    """K1, K2 (either epilogue) and K3 in the precise and the bf16 modes at
    the edges of their chunk geometry: (S, B) in EDGE_SB and D in EDGE_D on
    one- and two-block rings (the window wraps onto the block itself or its
    only neighbour; K3 on one shard a block), and at nb = 4 (two shards of
    two blocks) a ring with an all-zero band block and one whose rows all
    reach both window ends; the precise mode (f32), the bf16 mode with f32
    and bf16 storage; int8 and nibble.  Every launch is held to its plain
    version (the precise K1, K2 and K3 also to the f64 one, check_f64),
    launched twice for the same bits, the nibble build's launches to the
    int8 build's bits and the sharded operator to K1 on the whole graph (max
    abs difference 0 on the card; the CPU rehearsal's plain einsums may sum
    in another order, 2^-7 of max).  Returns max abs errors by counter."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh

    exact = 0.0 if device != "cpu" else 2.0 ** -7
    cases = [("ring", nb, S, B, D) for S, B in EDGE_SB for nb in (1, 2) for D in EDGE_D]
    cases += [(kind, 4, 256, B, D) for kind, B in (("hollow", 128), ("ends", 256))
              for D in EDGE_D]
    errs, t0 = {}, time.perf_counter()
    for kind, nb, S, B, D in cases:
        g8, g4 = (edge_graph(kind, nb, S, B, nib, device) for nib in (False, True))
        if g8.spill.nnz or (kind == "hollow" and g8.base[1].any()):
            raise AssertionError(f"edge graph {kind} S={S} B={B}: not as built for")
        gen = torch.Generator().manual_seed(D)
        aw, bw = (torch.randn(D, D, generator=gen).div(D ** 0.5).to(device) for _ in range(2))
        h32 = operands(g8, D, S + B, device)[0]
        row, col = scales(g8, nb, device)
        mesh = make_mesh(min(nb, 2), device)
        label = f"{kind} nb={nb} S={S} B={B} D={D}"
        for precise, store in PREC_MODES:
            h = h32.to(getattr(torch, store)).contiguous()
            outs = []
            for g in (g8, g4):
                o = {}
                calls = mode_calls(g, row, col, h, aw, bw, mesh, precise)
                for name, (kern, plain, cmp) in calls.items():
                    got = kern()
                    if not torch.equal(kern(), got):
                        raise AssertionError(f"{label} {name}: two launches differ")
                    nib = "_nib" if g.nibble else ""
                    errs[name + nib] = max(errs.get(name + nib, 0.0),
                                           cmp(f"{label} {name + nib}", got, plain(), quiet=True))
                    o[name] = got
                if precise:
                    ref = f64_calls(g, row, col, h, mirror_sub(g, col, h), aw, bw)
                    ref["band_halo"] = ref["band_spmm"]
                    for name, (ref64, ref64_plain) in ref.items():
                        check_f64(f"{label} {name}{nib}", o[name], ref64, calls[name][1](),
                                  ref64_plain, f"{name} (edges)")
                outs.append(o)
            for name in outs[0]:
                if not torch.equal(outs[0][name], outs[1][name]):
                    raise AssertionError(f"{label} {name}: nibble is not the int8 build's bits")
            m = mode_suffix(precise, store)
            k1, k3 = outs[0][f"band_spmm{m}"].float(), outs[0][f"band_halo{m}"].float()
            if (k3 - k1).abs().max().item() > exact * k1.abs().max().item():
                raise AssertionError(f"{label} band_halo{m}: the sharded operator is not K1's bits")
    log(f"check edges: {len(cases)} graphs x (precise, bf16 with f32 and bf16 storage) x "
        f"int8/nibble, K1, K2 (both epilogues) and K3 against their plain versions (precise: "
        f"and f64), relaunched, nibble = int8 and sharded = K1 bits: passed in "
        f"{time.perf_counter() - t0:.1f} s; max abs errors "
        + json.dumps({k: float(f"{v:.3e}") for k, v in sorted(errs.items())}))
    return errs


def check_split(device):
    """At 18,432 rows (72 blocks of 256) the launches split each block over
    CTAs of fewer rows (ops/band_kernels.rows_per_cta): K1, K2 (either
    epilogue) and the sharded operator (K3, GP shards) in the precise mode
    and the bf16 mode with both storages give the bits of whole-block CTAs,
    and are held to their plain versions.  Returns max abs errors by
    counter."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh

    g = synth_banded(18222, False, 0, device).dbg0
    split = bk.rows_per_cta(g.n_blocks, g.S, 132)
    h32, _ = operands(g, 64, 11, device)
    row, col = scales(g, 12, device)
    aw, bw = sage_weights(device)
    mesh = make_mesh(GP, device)
    errs = {}
    for precise, store in PREC_MODES:
        h = h32.to(getattr(torch, store)).contiguous()
        calls = mode_calls(g, row, col, h, aw, bw, mesh, precise)
        whole_rows = bk.rows_per_cta
        bk.rows_per_cta = lambda nb, S, sms: min(bk.MAX_ROWS, -(-S // 16) * 16)
        bk._plan.cache_clear()
        try:
            whole = {name: kern() for name, (kern, _, _) in calls.items()}
        finally:
            bk.rows_per_cta = whole_rows
            bk._plan.cache_clear()
        for name, (kern, plain, cmp) in calls.items():
            got = kern()
            if not torch.equal(got, whole[name]):
                raise AssertionError(f"{name} at 18,432 rows: split CTAs differ from whole blocks")
            errs[name] = cmp(f"18,432 rows, {split}-row CTAs, {name}", got, plain())
    return errs


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


def plain_operator(dbg, row, col, h, precise=True):
    """The full band operator from plain PyTorch operations only (K1's plain
    version, the mirror gather, the spill segment sum), so that autograd
    derives its gradient independently of BandSpmm; precise=False rounds the
    operands as K1's bf16 mode does (the spill runs on the unrounded col ⊙ h,
    as spmm_dense_band's)."""
    from mdcommunity_tpu_torch.ops.band_kernels import spmm_band_plain
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub
    from mdcommunity_tpu_torch.ops.spmm_csr import spmm_sorted

    out = spmm_band_plain(dbg, row, col, h, mirror_sub(dbg, col, h, precise), precise)
    if dbg.spill.nnz:
        out = out + spmm_sorted(dbg.spill, dbg.w_spill, h * col[:, None]) * row[:, None]
    return out


def check_backward(device, n):
    """torch.autograd.grad through BandSpmm (K1, and K1 with the scales
    swapped for the gradient) against autograd through the plain operator."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band_grad

    dbg = check_graph_a(n, device).dbg0
    log(f"check backward graph: n={n} C={dbg.C} spill={dbg.spill.nnz}")
    row, col = scales(dbg, 7, device)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(dbg.pad_n, 64, generator=gen).to(device).requires_grad_()
    g = torch.randn(dbg.pad_n, 64, generator=gen).to(device)
    (got,) = torch.autograd.grad(spmm_dense_band_grad(dbg, row, col, h), h, g)
    (ref,) = torch.autograd.grad(plain_operator(dbg, row, col, h), h, g)
    err = compare("K1 backward D=64, row != col, autograd", got, ref)
    h64 = h.detach().double().requires_grad_()
    (ref64,) = torch.autograd.grad(plain_operator(dbg, *f64(row, col), h64), h64, g.double())
    check_f64("K1 backward, autograd", got, ref64, ref, counter="band_spmm_bwd")
    return err


def check_bf16_backward(device, banded, label):
    """The bf16 operator's h-gradient (BandSpmm at precise=False: K1's bf16
    mode with row and col swapped, band_spmm_bf16_bwd) against its plain
    version, the plain operator in the bf16 mode applied with the scales
    swapped to the cotangent (the gradient the JAX package's VJP at
    precise=False defines: bf16(row ⊙ g), f32 sums), within REL_TOL of max,
    the bf16 forward rows' tolerance for f32 storage; two backward passes
    bit-identical."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band_grad

    dbg = banded.dbg0
    row, col = scales(dbg, 7, device)
    gen = torch.Generator().manual_seed(8)
    h = torch.randn(dbg.pad_n, 64, generator=gen).to(device).requires_grad_()
    g = torch.randn(dbg.pad_n, 64, generator=gen).to(device)

    def grad():
        return torch.autograd.grad(spmm_dense_band_grad(dbg, row, col, h, precise=False),
                                   h, g)[0]

    got = grad()
    err = compare(f"{label} K1-bf16 backward D=64, row != col (pad_n={dbg.pad_n}, "
                  f"C={dbg.C}, spill={dbg.spill.nnz})", got,
                  plain_operator(dbg, col, row, g, precise=False))
    if not torch.equal(grad(), got):
        raise AssertionError("two bf16 backward passes differ")
    return err


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
# K3 as the gradient's operator (row and col swapped), precise and bf16
HALO_BWD = (("band_halo_bwd", True, "float32"), ("band_halo_bf16_bwd", False, "float32"))


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
    errs = dict.fromkeys([m[0] for m in HALO_MODES + HALO_BWD], 0.0)
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
                if precise:
                    check_f64(f"K3 S={S} shard {i}", got, bk.spmm_band_halo_plain(*f64(*op)),
                              ref, counter=name)
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
        h64 = h.double().requires_grad_()
        (ref64,) = torch.autograd.grad(plain_operator(dbg, *f64(row, col), h64), h64,
                                       g.double())
        check_f64(f"K3 backward S={S}", dh, ref64, plain, counter="band_halo_bwd")
        # the bf16 fit's gradient: K3's bf16 mode with the scales swapped, the
        # unsharded one's (K1-bf16 swapped) bits, and its plain version
        dh = gather_nodes(mesh, list(torch.autograd.grad(spmm_band_sharded_grad(
            mesh, sdbg, split_nodes(mesh, row), split_nodes(mesh, col), hs, precise=False),
            hs, split_nodes(mesh, g))))
        (ref,) = torch.autograd.grad(spmm_dense_band_grad(dbg, row, col, hf, precise=False),
                                     hf, g)
        diff = (dh - ref).abs().max().item()
        log(f"check K3-bf16 backward S={S}: sharded vs unsharded bf16 gradient, max abs "
            f"difference {diff}")
        if diff > exact * ref.abs().max().item():
            raise AssertionError("the sharded bf16 gradient is not the unsharded one's bits")
        errs["band_halo_bf16_bwd"] = max(errs["band_halo_bf16_bwd"], compare(
            f"K3-bf16 backward S={S} vs the plain bf16 operator, scales swapped", dh,
            plain_operator(dbg, col, row, g, precise=False)))
    return errs


def time_halo_kernels(device, banded, label, gp=GP, timed=True):
    """K3 in each mode, and as the backward (row and col swapped, on a
    gradient), at D = 64 on layer 0 of `banded` split over gp shards: each
    shard's interior and boundary launches, the K3 launches of one sharded
    call (all shards) beside their plain versions, the library yardstick
    (torch.bmm of each shard's widened base against its materialised linear
    windows, bf16 for the bf16 modes) and the bound (each shard's base, h,
    halos, scales, mirror slice and output once); the whole sharded call
    (mirror glue and halos included) beside K1's whole-graph operator; and
    the launches of one sharded call.  Returns the whole-call numbers by
    counter (timed=False: the checks' errors only)."""
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
    for name, precise, store in HALO_MODES + HALO_BWD:
        dt = getattr(torch, store)
        if name.endswith("_bwd"):  # the gradient's operator: col and row swapped
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
        if not timed:
            res[name + nib] = dict(max_abs_err=err)
            continue
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
        if name == "band_halo_bf16_bwd":
            res[name + nib]["device_ms"] = device_time_ms(kern)
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
    shard against the whole graph's (f32), as one product a shard and by
    row_matmul, with the GEMM kernels cuBLAS picks at the two row counts
    (on the card; a diagnostic, logged empty where the profiler lost every
    record).  Counts set to 0 just before the sharded calls and read
    just after; returns them summed."""
    import torch

    from mdcommunity_tpu_torch.eval.metrics import top_k_stable
    from mdcommunity_tpu_torch.graphs.banded import shard_banded_duplex
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.utils.device import ROW_CHUNK, matmul_precision, row_matmul
    from mdcommunity_tpu_torch.utils.timing import kernel_names

    net = load_model(CKPT, device=device)
    sharded = shard_banded_duplex(make_mesh(gp, device), banded)
    covered = ~banded.node_mask
    x = torch.nn.functional.normalize(operands(banded.dbg0, 64, 12, device)[0], dim=-1)
    w = net.p_node_conv
    with matmul_precision(True):
        parts = torch.chunk(x, gp)
        whole = x @ w
        pieces = torch.cat([p @ w for p in parts])
        chunked = torch.cat([row_matmul(p, w) for p in parts])
        names = {} if device == "cpu" else {
            rows: kernel_names(lambda a=a: a @ w) for rows, a in ((len(parts[0]), parts[0]),
                                                                   (len(x), x))}
    log(f"dense layer [{banded.pad_n // gp}, 64] @ [64, 64] per shard vs [{banded.pad_n}, 64]"
        f" whole (f32): max abs diff {(pieces - whole).abs().max().item():.3e}, bit-equal "
        f"{torch.equal(pieces, whole)}; by row_matmul (chunks of {ROW_CHUNK} rows) "
        f"bit-equal {torch.equal(chunked, row_matmul(x, w))}; GEMM kernels by rows "
        + json.dumps(names))
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


def sharded_trainer_phase(device, banded, edges, k, gp=GP, iters=6, lr=1e-4,
                          variant="unit_cost", ckpt=CKPT_FIT, weights=None):
    """train_banded_loop of `variant` (the `ckpt` model; degree cost: the
    host envs hold the band-order `weights` that banded carries) with mesh
    = gp shards beside the unsharded loop,
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
    net = load_model(ckpt, device=device)
    runs = {}
    for which, mesh in (("unsharded", None), ("sharded", make_mesh(gp, device))):
        env = Recorder(make_host_env(banded.n_nodes, *edges, weights=weights,
                                     engine="native"))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        bk.reset_launches()
        net2, hist = train_banded_loop(net, banded, env, iters=iters, k=k, target_update=3,
                                       eps_start=1.0, eps_end=1.0, lr=lr, packed=False,
                                       mesh=mesh, log=log, log_every=iters,
                                       variant=variant)
        if on_card:
            torch.cuda.synchronize()
        counts = dict(bk.launches)
        rows = [h for h in hist if "loss" in h]
        peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
        runs[which] = dict(actions=env.actions, rows=rows, counts=counts, peak=peak,
                           params={n: p.detach().double().cpu()
                                   for n, p in net2.named_parameters()})
        log(f"sharded trainer phase, {which}: " + json.dumps(dict(
            variant=variant, pad_n=banded.pad_n, gp=gp if mesh else 1, k=k,
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
    log(f"sharded vs unsharded loop ({variant}): first loss rel diff {rel:.3e}, final parameters "
        f"max abs diff {worst:.3e} (bound {2 * lr * fits:.1e})")
    if not rel <= 1e-5 or not worst <= 2 * lr * fits:
        raise AssertionError("the sharded loop's fit differs from the unsharded one's")
    for name in ("band_halo", "band_halo_bwd"):
        if on_card and s["counts"][name] <= 0:
            raise AssertionError(f"kernel {name} was not launched in the sharded trainer phase")
    return s["counts"]


def bf16_fit_phase(device, banded, edges, k, gp=GP, iters=5):
    """The bf16 fit on the training path: train_banded_loop(precise=False)
    for `iters` iterations at k, unsharded and with gp shards on the one
    card, each beside the precise loop with the same settings on the same
    graph: fit ms (the median of the fitted iterations after the first,
    with their least and most), iteration p50.  Counts set to 0 just before each loop and read just
    after; the unsharded bf16 loop must launch band_spmm_bf16_bwd, the
    sharded one band_halo_bf16_bwd.  Returns the two bf16 loops' counts,
    summed."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.rl.big_trainer import train_banded_loop

    on_card = device != "cpu"
    net = load_model(CKPT_FIT, device=device)
    total = dict.fromkeys(bk.launches, 0)
    for label, mesh, want in (("unsharded", None, "band_spmm_bf16_bwd"),
                              (f"gp={gp}", make_mesh(gp, device), "band_halo_bf16_bwd")):
        fit_ms, spread = {}, {}
        for precise in (True, False):
            env = make_host_env(banded.n_nodes, *edges, engine="native")
            if on_card:
                torch.cuda.synchronize()
            bk.reset_launches()
            net2, hist = train_banded_loop(net, banded, env, iters=iters, k=k,
                                           target_update=iters, precise=precise, mesh=mesh,
                                           log=log, log_every=iters)
            if on_card:
                torch.cuda.synchronize()
            counts = dict(bk.launches)
            rows = [h for h in hist if "loss" in h]
            fitted = [h for h in rows if h["removed"] == k]
            if len(fitted) < 2 or not np.isfinite([h["loss"] for h in fitted]).all():
                raise AssertionError("the loop did not fit full batches to a finite loss")
            if not sum((a - b.detach()).abs().sum().item()
                       for a, b in zip(net.parameters(), net2.parameters())) > 0:
                raise AssertionError("the parameters did not move")
            fit_s = [h["t_fit_s"] for h in fitted[1:]]
            fit_ms[precise] = 1e3 * float(np.median(fit_s))
            spread[precise] = f"{1e3 * min(fit_s):.2f}-{1e3 * max(fit_s):.2f}"
            log("bf16 fit phase: " + json.dumps(dict(
                pad_n=banded.pad_n, k=k, mesh=label, precise=precise,
                fit_ms=fit_ms[precise], fit_ms_min=1e3 * min(fit_s),
                fit_ms_max=1e3 * max(fit_s), fitted=len(fit_s),
                iter_p50_s=float(np.median([h["t_iter_s"] for h in rows])),
                losses=[h["loss"] for h in rows],
                launches={c: v for c, v in counts.items() if v})))
            if not precise:
                total = {c: total[c] + counts[c] for c in total}
                if on_card and counts[want] <= 0:
                    raise AssertionError(f"kernel {want} was not launched by the bf16 fit")
        log(f"bf16 fit vs precise fit, {label}, pad_n={banded.pad_n}, k={k}: fit ms "
            f"{fit_ms[False]:.2f} (bf16, {spread[False]}) against {fit_ms[True]:.2f} "
            f"(precise, {spread[True]})")
    return total


# ---------------------------------------------------------------- the DQN trainer

DQN_ITERS = 201    # validations at iterations 0 and 200 (save_frequency DQN_ITERS - 1)
DQN_MORE = 5       # the resumed run's iterations


def dqn_phase(device, cfg=None, iters=DQN_ITERS, more=DQN_MORE, variant="unit_cost"):
    """The small-graph DQN trainer of `variant` at Config()'s full width (or
    `cfg`): DQNAgent(cfg, device).train for `iters` iterations into a
    git-ignored directory, with its warm-up, play and validation seconds,
    fit iterations a second, both VCs, peak device memory and, for CE, its
    LMCC-DEBUG and CE-PRIOR lines; counts set to 0 just before and read just
    after (the dense engine launches no hand kernel, as in the JAX
    package).  Then a resume from latest.ckpt for `more` iterations, after
    checking that loading it restores the iteration, the Adam state, both
    generators' states and the weights.  Then one replay batch through
    train_step on `device` and on the CPU (hold_train_step, by the
    variant's rule).  Returns (the readings, the trained agent)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.config import Config

    cfg = dataclasses.replace(cfg or Config(save_frequency=iters - 1), max_iteration=iters,
                              variant=variant)
    save_dir = os.path.join(OUT, "dqn" if variant == "unit_cost" else f"dqn_{variant}")
    shutil.rmtree(save_dir, ignore_errors=True)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    agent = DQNAgent(cfg, device=device)
    stats = {}
    ce_lines = []

    def train_log(line):
        if line.startswith(("LMCC-DEBUG", "CE-PRIOR")):
            ce_lines.append(line)
        log(line)

    reset_all_launches()
    t0 = time.perf_counter()
    agent.train(save_dir=save_dir, log=train_log, stats=stats)
    wall = time.perf_counter() - t0
    counts = all_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    result = dict(
        variant=variant, iters=iters, batch_size=cfg.batch_size, num_env=cfg.num_env,
        n_train=cfg.n_train,
        n_valid=cfg.n_valid, embedding_size=cfg.embedding_size, pools_s=stats["pools_s"],
        warmup_s=stats["warmup_s"], play_s=stats["play_s"], fit_s=stats["fit_s"],
        fit_iters_per_s=stats["fit_iters"] / stats["fit_s"], valid_s=stats["valid_s"],
        vcs=stats["vcs"], peak_mem_gib=peak, wall_s=wall,
        launches={c: v for c, v in counts.items() if v})
    if variant == "ce":
        result["ce_lines"] = ce_lines
    log("dqn phase: " + json.dumps(result))
    n_val = (iters - 1) // cfg.save_frequency + 1
    if variant == "ce" and len(ce_lines) != 2 * n_val:
        raise AssertionError("the CE run did not log its LMCC-DEBUG and CE-PRIOR lines")
    if len(stats["vcs"]) != n_val or not all(0.0 < v < 3.0 for v in stats["vcs"]):
        raise AssertionError("the DQN run's validation VCs are out of range")
    for f in ("latest.ckpt", "best_model.ckpt", f"ModelVC_{cfg.num_min}_{cfg.num_max}.csv",
              f"nrange_{cfg.num_min}_{cfg.num_max}_iter_0.ckpt"):
        if not os.path.isfile(os.path.join(save_dir, f)):
            raise AssertionError(f"the DQN run did not write {f}")

    # resume: latest.ckpt restores everything, then the run continues
    saved = agent._state_dict()
    resumed = DQNAgent(dataclasses.replace(cfg, max_iteration=iters + more), device=device)
    resumed.load(os.path.join(save_dir, "latest.ckpt"))
    back = resumed._state_dict()
    same = (back["iteration"] == saved["iteration"] == iters
            and back["adam_step"] == saved["adam_step"] == iters
            and back["nprng"] == saved["nprng"]
            and np.array_equal(back["torch_rng"], saved["torch_rng"])
            and all(np.array_equal(back[k][n], saved[k][n])
                    for k in ("adam_m", "adam_v") for n in saved[k])
            and all(np.array_equal(a, b) for a, b in zip(
                _leaves(back["params"]), _leaves(saved["params"]))))
    if not same:
        raise AssertionError("latest.ckpt did not restore the agent's state")
    resumed.train(save_dir=save_dir, resume=True, log=log)
    step = resumed._state_dict()["adam_step"]
    log(f"dqn resume ({variant}): restored iteration {iters}, Adam step {iters} and both "
        "generators; "
        f"continued to iteration {resumed.iteration}, Adam step {step}")
    if resumed.iteration != iters + more or step != iters + more:
        raise AssertionError("the resumed run did not continue from the saved iteration")

    # one train_step on the device and on the CPU, from the same parameters
    held = hold_train_step(device, agent)
    return dict(result, **held), agent


@functools.lru_cache(maxsize=None)
def gradient_rules():
    """tests/gradient_rules.py, the train step's gradient rules that the CPU
    tests hold the port to (it imports torch only), loaded once."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gradient_rules", os.path.join(HERE, "tests", "gradient_rules.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _step_on(dev, agent, args, dtype=None, terms=False):
    """One train_step of the agent's nets on `dev` (without an optimizer
    step), its batch `args` moved there, floats in `dtype` when given (the
    CPU's f64 referee).  terms: under gradient_rules.gate_terms, which
    collects the gate leaves' terms.  Returns (loss, td, the net, the
    gate leaves' Σ|terms| or None)."""
    import contextlib
    import copy

    from mdcommunity_tpu_torch.rl.dqn import train_step
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    def move(v):
        if v is None:
            return None
        if hasattr(v, "map"):
            return v.map(lambda t: t.to(dev, dtype) if dtype and t.is_floating_point()
                         else t.to(dev))
        return v.to(dev, dtype) if dtype and v.is_floating_point() else v.to(dev)

    a = {k: move(v) for k, v in args.items()}
    net, tnet = (copy.deepcopy(m).to(dev) for m in (agent.net, agent.target_net))
    if dtype is not None:
        net, tnet = net.to(dtype), tnet.to(dtype)
    hook = gradient_rules().gate_terms(net) if terms else contextlib.nullcontext()
    with hook, matmul_precision(True):
        loss, _, _, td = train_step(net, tnet, None, **a, **agent.step_options())
    return loss.item(), td.double().cpu(), net, hook.sums() if terms else None


def hold_train_step(device, agent):
    """One replay batch of `agent` through train_step on `device` and on the
    CPU (plain PyTorch) from the same parameters, by the rules of
    tests/gradient_rules.py that the CPU tests hold the port to.  Unit
    cost: the loss within 1e-5 relative, every gradient leaf within
    GRAD_TOL of its max|grad| (a leaf under LEAF_FLOOR of the largest
    leaf's is held against that floor).  CE: the same, the gate leaves
    (the fusion bias logis_b, which cancels) also within TERMS_TOL of their
    terms' absolute sum, from the CPU's run (tests/test_torch_variants_train.py).
    HCA (tests/test_torch_hca_train.py's rule): the card's and the CPU's
    f32 each against the CPU's f64 referee, the loss within 1e-5 relative,
    each TD within HCA_TD_TOL of its operands' magnitude, each leaf within
    GRAD_TOL of its own max|grad|, a gate leaf also within TERMS_TOL of its
    terms.  Each leaf's error is logged against its own max; the readings
    give the worst leaf's error as a share of its tolerance."""
    import torch

    rules = gradient_rules()
    variant = agent.cfg.variant
    batch, _, iw, _ = agent.sample_batch()
    args = agent.step_args(batch, iw)
    l_dev, td_dev, n_dev = _step_on(device, agent, args)[:3]
    l_cpu, td_cpu, n_cpu, terms = _step_on("cpu", agent, args, terms=variant == "ce")
    g_dev, g_cpu = ({k: p.grad.detach().double().cpu().numpy() for k, p in n.named_parameters()}
                    for n in (n_dev, n_cpu))
    if variant != "hca":
        tols = rules.leaf_tolerances(g_cpu, terms)
        worst = 0.0
        for k, ref in g_cpu.items():
            scale = abs(ref).max()
            err = abs(g_dev[k] - ref).max()
            log(f"  {variant} train_step grad {k}: max|g| {scale:.3e}  {device} vs CPU "
                f"{err:.3e} ({err / max(scale, 1e-30):.3e} of its max, "
                f"{err / tols[k]:.3e} of its tolerance)")
            worst = max(worst, err / tols[k])
        rel = abs(l_dev - l_cpu) / abs(l_cpu)
        log(f"dqn train_step ({variant}) {device} vs CPU: loss {l_dev:.9e} vs {l_cpu:.9e} "
            f"(rel {rel:.3e}); worst gradient leaf {worst:.3e} of its tolerance")
        if not rel <= 1e-5 or not worst <= 1.0:
            raise AssertionError(f"the {variant} train step on the device differs from the CPU's")
        return dict(train_step_loss_rel=rel, train_step_worst_leaf=worst)
    l_64, td_64, n_64, terms = _step_on("cpu", agent, args, torch.float64, terms=True)
    g_64 = {k: p.grad.detach().cpu().numpy() for k, p in n_64.named_parameters()}
    tols = rules.hca_leaf_tolerances(g_64, terms)
    # Q(s, a) of the batch, for the TDs' magnitude
    from mdcommunity_tpu_torch.rl.dqn import predict_q

    q_all = predict_q(n_64, args["g"].map(lambda t: t.cpu().double() if t.is_floating_point()
                                          else t.cpu()),
                      args["covered_st"].cpu(), args["sever_st"].cpu(), "hca")
    q_sa = q_all[torch.arange(q_all.shape[0]), args["actions"].cpu()]
    mag = torch.clamp(torch.maximum(q_sa.abs(), (q_sa + td_64).abs()), min=1.0)
    out = {}
    for name, loss, td, grads in (("card", l_dev, td_dev, g_dev), ("cpu", l_cpu, td_cpu, g_cpu)):
        rel = abs(loss - l_64) / abs(l_64)
        td_share = ((td - td_64).abs() / mag).max().item()
        worst = 0.0
        for k, ref in g_64.items():
            scale = abs(ref).max()
            err = abs(grads[k] - ref).max()
            share = err / tols[k] if tols[k] else (0.0 if err == 0 else float("inf"))
            if name == "card":
                log(f"  hca train_step grad {k}: max|g| {scale:.3e}  card vs CPU f64 "
                    f"{err:.3e} ({err / max(scale, 1e-300):.3e} of its max, "
                    f"{share:.3e} of its tolerance)")
            worst = max(worst, share)
        out[name] = dict(loss_rel=rel, td_share=td_share, worst_leaf=worst)
    log(f"dqn train_step (hca) vs the CPU's f64: loss {l_64:.9e}, logis_b's Σ|terms| "
        f"{terms['fusion.logis_b'][0]:.3e}, " + json.dumps(out))
    for o in out.values():
        if (not o["loss_rel"] <= 1e-5 or not o["td_share"] <= rules.HCA_TD_TOL
                or not o["worst_leaf"] <= 1.0):
            raise AssertionError("the hca train step on the device or the CPU differs from "
                                 "the CPU's f64 referee beyond the HCA rule")
    return dict(train_step_loss_rel=out["card"]["loss_rel"],
                train_step_worst_leaf=out["card"]["worst_leaf"])


def _leaves(tree):
    """A parameter tree's arrays in key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


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


EDGE_HUB, EDGE_DEAD = 70, (100, 150)   # edge_blocked's hub row, dead rows


def edge_blocked(device):
    """The blocked kernels' edge layout: S = 64, T = 100 (T % 32 != 0, so
    K5's 32-slot groups straddle pairs), 1,000 nodes (the last block
    padded), a hub row (row 70, 305 slots) half of whose edges come from one
    source block (a pair of several T-slot chunks), rows 100-149 whose every
    slot is dead (w = 0; some have no slot at all), and padded pairs.
    Returns (bcoo, w)."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.ops.blocked_kernels import build_block_coo

    rng = np.random.default_rng(21)
    n, S, T = 1000, 64, 100
    src = np.concatenate([rng.integers(0, n, 5000), rng.integers(0, n, 150),
                          rng.integers(128, 192, 150)])
    dst = np.concatenate([rng.integers(0, n, 5000), np.full(300, EDGE_HUB)])
    bcoo, _, sdst, mask = build_block_coo(src, dst, n, S, T, device=device)
    w = rng.random(mask.size) * mask
    w[(sdst >= EDGE_DEAD[0]) & (sdst < EDGE_DEAD[1])] = 0
    rp = bcoo.row_ptr.cpu().numpy()
    counts = np.diff(rp)
    if not (counts[EDGE_HUB] > 64 and bcoo.T % 32 != 0
            and int(bcoo.rowptr[-1]) < bcoo.n_pairs
            and counts[EDGE_DEAD[0]:EDGE_DEAD[1]].max() > 0):
        raise AssertionError("the edge layout lacks a hub row, T % 32 != 0, "
                             "padded pairs or dead rows")
    w = torch.from_numpy(w.astype(np.float32)).reshape(bcoo.n_pairs, bcoo.T)
    return bcoo, w.to(device)


def check_blocked(device):
    """K4 and K5 against their plain versions: on the random layout at D =
    64 and 48 (K4 writes nothing into the empty block); on the edge layout
    (edge_blocked) at D = 2, 30, 64, 160 and 300 (widths that are not a
    multiple of 4, and K4's and K5's column passes), and at D = 64 with h
    and g not 16-byte aligned (the kernels' scalar path), where K4 gives
    exact zeros on the dead rows.  Every launch is made twice and must give
    the same bits."""
    import torch

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk

    gen = torch.Generator().manual_seed(13)
    errs = {"spmm_block": 0.0, "sddmm_block": 0.0}

    def operand(rows, D, misaligned=False):
        x = torch.randn(rows * D + 1, generator=gen).to(device)
        return (x[1:] if misaligned else x[:-1]).view(rows, D)

    def both(label, bcoo, w, h, g):
        """K4 and K5 on these operands, each launched twice (the same bits)
        and held to its plain version; returns K4's output."""
        outs = {}
        for name, kern, plain in (
            ("spmm_block", lambda: bk.spmm_block(bcoo, w, h), bk.spmm_block_plain(bcoo, w, h)),
            ("sddmm_block", lambda: bk.sddmm_block(bcoo, h, g), bk.sddmm_block_plain(bcoo, h, g)),
        ):
            outs[name] = kern()
            if not torch.equal(outs[name], kern()):
                raise AssertionError(f"{name} {label}: two launches differ")
            errs[name] = max(errs[name], compare(f"{name} {label}", outs[name], plain))
        return outs["spmm_block"]

    bcoo, w = random_blocked(device)
    for D in (64, 48):
        out = both(f"random layout D={D}", bcoo, w, operand(bcoo.n_rows, D),
                   operand(bcoo.n_rows, D))
        if out[512:1024].abs().max().item() != 0:
            raise AssertionError("K4 wrote into the empty destination block")
    bcoo, w = edge_blocked(device)
    for D, mis in ((2, False), (30, False), (64, False), (160, False), (300, False),
                   (64, True)):
        label = f"edge layout S=64 T=100 D={D}" + (" misaligned" if mis else "")
        out = both(label, bcoo, w, operand(bcoo.n_rows, D, mis), operand(bcoo.n_rows, D, mis))
        if out[EDGE_DEAD[0]:EDGE_DEAD[1]].abs().max().item() != 0:
            raise AssertionError(f"K4 {label}: a row whose every slot is dead is not 0")
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
    real slot (padding it never visits) its slot id, source row and
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
    torch.sparse.sampled_addmm on the real slots' pattern for K5): ms and
    library_ms by CUDA events around each call (the wrapper's host work
    included), device_ms and library_device_ms the kernels' own device
    time (device_time_ms)."""
    import torch

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk
    from mdcommunity_tpu_torch.time_blocked_rows import blocked_calls

    bcoo, w, h = blocked_operands(bd, 14, device)
    g = torch.nn.functional.normalize(torch.randn_like(h), dim=-1)
    res = {}
    for name, kern, plain, lib in blocked_calls(bk, bcoo, w, h, g):
        err = compare(f"{label} {name}", kern(), plain())
        bound_ms, bound_by = blocked_bounds(bcoo, w, h.shape[1], name)
        res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=time_ms(lib),
                         device_ms=device_time_ms(kern),
                         library_device_ms=device_time_ms(lib), max_abs_err=err)
        log(f"time {label} {name}: n_rows={bcoo.n_rows} P={bcoo.n_pairs} slots={bcoo.n_slots} "
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
    from mdcommunity_tpu_torch.ops import (
        band_kernels,
        blocked_kernels,
        cascade_kernels,
        probe_kernels,
    )

    band_kernels.reset_launches()
    blocked_kernels.reset_launches()
    probe_kernels.reset_launches()
    cascade_kernels.reset_launches()


def all_launches():
    from mdcommunity_tpu_torch.ops import (
        band_kernels,
        blocked_kernels,
        cascade_kernels,
        probe_kernels,
    )

    return {**band_kernels.launches, **blocked_kernels.launches, **probe_kernels.launches,
            **cascade_kernels.launches}


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


def main_graph_file(n):
    """Write the graph of `large_graph_demo --sizes n` (the generator's first
    draw) as OUT/synthetic_<n>_multiplex.edges; returns its name."""
    import numpy as np

    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges, write_edges

    e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0))
    os.makedirs(OUT, exist_ok=True)
    name = f"synthetic_{n}_multiplex.edges"
    write_edges(os.path.join(OUT, name), e0, e1)
    return name


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
    from mdcommunity_tpu_torch.ops import cascade_kernels as ck

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
    shadow = Lockstep(net, os.path.join(OUT, name), n, max(int(step_ratio * n), 1))

    stats = {}
    bk.reset_launches()
    ck.reset_launches()
    t0 = time.perf_counter()
    sol, solve_s, score = evaluate_real(
        net, OUT, name, os.path.join(OUT, "results"), n_nodes=n, layers=(1, 2),
        step_ratio=step_ratio, batch_env=True, blocked_threshold=0,
        device=device, engine="native",
        stats=stats, shadow=shadow,
    )
    if device != "cpu":
        torch.cuda.synchronize()
    counts = {**bk.launches, **ck.launches}  # the cascade's: the env went to the card
    lockstep = shadow.summary()
    mean_fwd = 1e3 * stats["model_call_s"] / max(stats["model_calls"], 1)
    log("main path: " + json.dumps(dict(
        n=n, step_ratio=step_ratio, audc=score, removed=len(sol),
        solve_s=solve_s, wall_s=time.perf_counter() - t0, lockstep_s=stats["shadow_s"],
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
        ck.reset_launches()
        sol2, score2, _ = dismantle_greedy_banded(
            net, banded, env, step=max(int(step_ratio * n), 1), batch_env=True,
            max_steps=n // 10)
        more = {**bk.launches, **ck.launches}
        log("main path, unshuffled phase: " + json.dumps(dict(
            removed=len(sol2), score=score2, launches=more)))
        counts = {k: counts[k] + more[k] for k in counts}
    return counts, dict(audc=score, removed=len(sol), mean_model_call_ms=mean_fwd,
                        lockstep=lockstep)


class Lockstep:
    """The main path's own rollout held to the port's CPU forward (the
    plain versions): the shadow of dismantle_greedy_banded.  At each of the
    first `calls` model calls it runs the CPU forward of `variant` on its
    own band (built from the same edge file with the variant's structure
    `extra`, severed as the env reports) and compares its valid top-`step`
    prefix with the batch the card's call takes, until the first call where
    they differ.  A parting must be a near-tie (near_tie: each side ranks
    its own pick first, within TIE of the scale eval/metrics.tie_scale
    reads, max|Q| over the Q above -1e8, which is every Q of the base
    variants, or for two of HCA's unselected nodes at -1e9·w their own
    magnitude), else this raises; it is logged with its removal index and
    gap."""

    def __init__(self, net, path, n, step, calls=LOCKSTEP_CALLS, variant="unit_cost",
                 extra=None):
        import copy

        from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges

        raw = read_multiplex_edges(path, n)
        self.band, self.hd = variant_band(variant, n, raw[1], raw[2], extra or {}, "cpu")
        self.net = copy.deepcopy(net).to("cpu")
        self.variant = variant
        self.label = "main path" if variant == "unit_cost" else variant
        self.step, self.calls, self.left = step, 0, calls
        self.removed, self.seen, self.parting, self.t = 0, None, None, 0.0

    def __call__(self, env, q, covered, acts):
        import numpy as np
        import torch

        from mdcommunity_tpu_torch.eval.metrics import top_k_stable
        from mdcommunity_tpu_torch.graphs.banded import apply_severs

        if self.left == 0:
            return
        t0 = time.perf_counter()
        if self.seen is None:
            self.seen = [np.zeros_like(m) for m in env.sever]
        for layer in range(2):
            e = env.edges[layer][env.sever[layer] & ~self.seen[layer]]
            if len(e):
                e = torch.from_numpy(np.asarray(e, np.int64))
                apply_severs(self.band, layer, e[:, 0], e[:, 1],
                             torch.ones(len(e), dtype=torch.bool))
            self.seen[layer] = env.sever[layer].copy()
        qh = variant_forward(self.variant, self.net, self.band, self.hd, covered.cpu())
        vals, order = top_k_stable(qh, self.step)
        ok = np.isfinite(vals) & ~env.covered[order]
        a_h = order[: int(np.argmin(ok)) if not ok.all() else len(ok)]
        self.left -= 1
        self.calls += 1
        if not np.array_equal(acts, a_h):
            self.left = 0
            self.report(acts, a_h, q.cpu().numpy(), qh.numpy())
        self.removed += len(acts)
        self.t += time.perf_counter() - t0

    def report(self, a_c, a_h, qc, qh):
        from mdcommunity_tpu_torch.eval.metrics import tie_scale

        i = next((i for i, (x, y) in enumerate(zip(a_c, a_h)) if x != y),
                 min(len(a_c), len(a_h)))
        x, y = int(a_c[min(i, len(a_c) - 1)]), int(a_h[min(i, len(a_h) - 1)])
        s_c, s_h = tie_scale(qc, x, y), tie_scale(qh, x, y)
        scale = s_h or float("nan")
        self.parting = dict(
            call=self.calls - 1, removal=self.removed + i, card_takes=x, cpu_takes=y,
            q_card=[float(qc[x]), float(qc[y])], q_cpu=[float(qh[x]), float(qh[y])],
            gap_card=float(qc[x] - qc[y]), gap_cpu=float(qh[y] - qh[x]),
            gap_card_share=float(qc[x] - qc[y]) / (s_c or float("nan")),
            gap_cpu_share=float(qh[y] - qh[x]) / scale, tie=TIE * scale,
            scale_read="|Q| of the two (HCA unselected)" if qh[x] <= -1e8 else "max|Q| above -1e8")
        log(f"{self.label} lockstep, card vs CPU: first parting " + json.dumps(self.parting))
        if not near_tie(qc, qh, x, y):
            raise AssertionError(f"the card's {self.label} parts from the CPU's at a "
                                 "decision that is not a near-tie")

    def summary(self):
        out = dict(calls=self.calls, removals=self.removed, parted=self.parting is not None,
                   wall_s=self.t)
        log(f"{self.label} lockstep, card vs CPU: " + json.dumps(out))
        return dict(out, parting=self.parting)


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


def compare_epi(name, got, ref, quiet=False):
    """K2's bf16 epilogue against its plain version (EPI_TOL, EPI_SHARE)."""
    import torch

    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item()
    ulp = (torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
           if got.dtype == torch.bfloat16 else 0.0)
    share = (err <= REL_TOL * scale + ulp).float().mean().item()
    worst = err.max().item()
    if not quiet:
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

    dbg = check_graph_a(n, device).dbg0
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


def yardstick(dbg, h, col, dtype, own=False):
    """ms of the library yardstick: torch.bmm of the widened base against
    the materialised col ⊙ h windows, in `dtype`; own=True (the hlin
    variant's) the base's own S window columns [B, B + S) against each
    block's own rows of col ⊙ h."""
    import torch

    from mdcommunity_tpu_torch.ops.band_kernels import _windows

    base = widened(dbg, dtype)
    x = (h.float() * col[:, None]).to(dtype)
    if own:
        base = base[:, :, dbg.B:dbg.B + dbg.S].contiguous()
        win = x.view(dbg.n_blocks, dbg.S, -1)
    else:
        win = _windows(x, dbg.n_blocks, dbg.S, dbg.B).contiguous()
    ms = time_ms(lambda: torch.bmm(base, win))
    del base, win
    return ms


def time_epi_kernels(device, banded, label, timed=True):
    """K2's bf16 epilogue in its three modes at D = 64 on layer 0 of `banded`
    (spill-free) beside its bound (K2's), its plain version and the library
    yardstick, after a check at these shapes.  Returns numbers by counter
    (timed=False: the checks' errors only)."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    h = torch.nn.functional.normalize(h, dim=-1)
    aw, bw = sage_weights(device)
    lib = {dt: yardstick(dbg, h, live, dt) for dt in (torch.float32, torch.bfloat16)
           if timed}
    res, nib = {}, "_nib" if dbg.nibble else ""
    for name, precise, store in EPI_MODES:
        hh = h.to(getattr(torch, store)).contiguous()
        sub = mirror_sub(dbg, live, hh, precise)

        def kern():
            return bk.sage_step(dbg, live, live, hh, sub, aw, bw, precise, f32_epi=False)

        def plain():
            return bk.sage_step_plain(dbg, live, live, hh, sub, aw, bw, precise, False)

        err = compare_epi(f"{label} {name + nib}", kern(), plain())
        if not timed:
            res[name + nib] = dict(max_abs_err=err)
            continue
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


def time_diag_kernels(device, banded, label, timed=True):
    """K1's four timing variants in the f32 and bf16 modes at D = 64 on
    layer 0 of `banded`, beside their bounds (diag_bounds), their references
    (diag_reference) and, for noscale (the unscaled operator) and hlin (the
    band's own columns), the library yardstick (`yardstick`).  nodot (a
    roll of col ⊙ h and a row scale) and noh (the mirror expansion and a row
    scale) have none: no one PyTorch call computes either.  noh and hlin
    need the card.  Returns numbers by counter (timed=False: the checks'
    errors only)."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    dbg = banded.dbg0
    h, live = operands(dbg, 64, 5, device)
    ones = torch.ones_like(live)
    res = {}
    for precise in (True, False):
        sub = mirror_sub(dbg, live, h, precise)
        dt = torch.float32 if precise else torch.bfloat16
        lib = {"noscale": yardstick(dbg, h, ones, dt)} if timed else {}
        for d in DIAG_NAMES:
            if device == "cpu" and d in ("noh", "hlin"):
                continue
            if d == "hlin" and timed:
                lib[d] = yardstick(dbg, h, live, dt, own=True)

            def kern(d=d):
                return bk.spmm_band(dbg, live, live, h, sub, precise=precise, diag=d)

            def plain(d=d):
                return diag_reference(dbg, live, live, h, sub, d, precise)

            name = f"band_spmm{'' if precise else '_bf16'}_diag_{d}"
            err = compare(f"{label} {name}", kern(), plain())
            if not timed:
                res[name] = dict(max_abs_err=err)
                continue
            bound_ms, bound_by = diag_bounds(dbg, 64, d, precise)
            res[name] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), bound_ms=bound_ms,
                             bound_by=bound_by, max_abs_err=err,
                             library_ms=lib.get(d))
            log(f"time {label} {name}: pad_n={dbg.pad_n} C={dbg.C} " + json.dumps(res[name]))
    return res


def time_stream(device, banded, label, G=8, timed=True):
    """The stream probe over layer 0's stored base [nb, S+C, W2] in groups
    of G blocks, with and without the masked reductions, beside its bound
    (the base read once), its plain version and, without them, the library
    call torch.sum(..., dtype=float32) of the same groups.  Returns numbers
    by counter (timed=False: the checks' errors only)."""
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
        if not timed:
            res[name] = dict(max_abs_err=err)
            continue
        res[name] = dict(
            ms=time_ms(lambda: stream_sum(x, G, extra)),
            plain_ms=time_ms(lambda: stream_sum_plain(x, G, extra)),
            bound_ms=1e3 * x.numel() / PEAK_BYTES_S, bound_by="bytes", max_abs_err=err,
            library_ms=None if extra else time_ms(
                lambda: torch.sum(flat, dim=1, dtype=torch.float32)))
        log(f"time {label} {name}: shape={list(x.shape)} G={G} " + json.dumps(res[name]))
    return res


def time_slice6(device, banded, nib, nib_clean, label, timed=True):
    """This slice's modes at `banded`'s shapes: K2's bf16 epilogue, K1's diag
    variants and the stream probe on `banded`; K1, K1's backward, K2 with
    either epilogue and their bf16 modes on the nibble build `nib`, and K3
    on the spill-free nibble build `nib_clean` (synth_banded(nibble=True)).
    Returns numbers by counter (timed=False: the checks' errors only)."""
    import torch

    res = time_epi_kernels(device, banded, label, timed)
    res.update(time_diag_kernels(device, banded, label, timed))
    res.update(time_stream(device, banded, label, timed=timed))
    res.update(time_kernels(device, nib, label, timed))
    res.update(time_bf16_kernels(device, nib, label, timed))
    res.update(time_epi_kernels(device, nib, label, timed))
    res.update(time_halo_kernels(device, nib_clean, label, timed=timed))
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


def probe_phase(device, small=False):
    """The slice's path: the four probe entry points through their mains,
    probe_f32_epi at 18,222 nodes and bench_nibble (its check at 2^16
    rows, its timing at 2^18: the 2^20 nibble modes are held in main's
    2^20-row checks), tune_band --diag and probe_hbm_roof at 2^20 (few
    repetitions),
    every launch count set to 0 just before and read just after; tune_band
    and probe_hbm_roof share one ring build (graphs/synth.ring_band_graph,
    n nodes and 4n edges), which phase 16's bench_spmm reuses.  small: the
    CPU rehearsal's sizes.  Returns the counts and the ring build."""
    from mdcommunity_tpu_torch import bench_nibble, probe_f32_epi, probe_hbm_roof, tune_band
    from mdcommunity_tpu_torch.graphs.synth import ring_band_graph

    import torch

    quick = ["--reps", "3", "--warm", "1"]
    n = 4096 if small else 1 << 20
    if small:
        quick += ["--device", "cpu"]
    t0 = time.perf_counter()
    ring = ring_band_graph(n, 4 * n, device=device)
    log(f"probe ring build (n={n}): {time.perf_counter() - t0:.1f} s")
    runs = [
        (probe_f32_epi, ["--n", "2048"] if small else [], {}),
        (bench_nibble, ["--n-check", "4096", "--n", "4096"] if small else
         ["--n-check", str(1 << 16), "--n", str(1 << 18)], {}),
        (tune_band, ["--diag", "--n", str(n)], dict(ring=ring)),
        (probe_hbm_roof, ["--n", str(n)], dict(ring=ring)),
    ]
    reset_all_launches()
    for probe, argv, kw in runs:
        t1 = time.perf_counter()
        probe.main(argv + quick, **kw)
        log(f"probe {probe.__name__.rsplit('.', 1)[1]}: {time.perf_counter() - t1:.1f} s")
    counts = all_launches()
    log(f"probe phase: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    if device != "cpu":
        torch.cuda.empty_cache()
    return counts, ring


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


# ---------------------------------------------------------------- variants

# the committed checkpoint of each variant beside unit cost
VARIANT_CKPTS = (("degree_cost", "degree_100k_r5"), ("ce", "ce_100k_r5"),
                 ("hca", "hca_100k_r5"))
VARIANT_LOCKSTEP = 10    # model calls of each variant's run held to the CPU's forward
COMM_D = (128, 256)      # K1's widths for the HCA community pass; 512 is chunked
STRUCTURES = {}          # variant -> (structure, seconds): variant_structures


def near_tie(qc, qh, x, y):
    """Whether the card taking x and the CPU taking y (Q vectors qc, qh of
    one state) is an f32 near-tie: each ranks its own pick first, by a gap
    of at most TIE of the scale eval/metrics.tie_scale reads on its side."""
    from mdcommunity_tpu_torch.eval.metrics import tie_scale

    s_c, s_h = tie_scale(qc, x, y), tie_scale(qh, x, y)
    if s_c is None or s_h is None:
        return False
    return bool(qc[x] >= qc[y] and qh[y] >= qh[x] and qc[x] - qc[y] <= TIE * s_c
                and qh[y] - qh[x] <= TIE * s_h)


def variant_structure_timed(variant, n):
    """The variant's structure (graphs/io.variant_structure) of the main
    path's graph and the host seconds it took (Louvain and features); CE's
    prior goes through evaluate_real's cache, written here afresh (a cache
    of an earlier run would skip the Louvain being timed)."""
    from mdcommunity_tpu_torch.graphs.io import (
        read_multiplex_edges,
        real_cache_id,
        variant_structure,
    )

    path = os.path.join(OUT, main_graph_file(n))
    raw = read_multiplex_edges(path, n)
    cache = os.path.join(OUT, f"results_{variant}", "real_cache")
    shutil.rmtree(cache, ignore_errors=True)
    t0 = time.perf_counter()
    extra = variant_structure(n, raw[1], raw[2], variant == "degree_cost",
                              "boundary" if variant == "ce" else None,
                              (cache, real_cache_id(path, (1, 2))), hca=variant == "hca")
    return extra, time.perf_counter() - t0


def variant_structures(n):
    """Every variant's structure into STRUCTURES (main runs this on the host
    while nvcc builds the kernels); a variant missing there is made by
    variant_path itself."""
    for variant, _ in VARIANT_CKPTS:
        STRUCTURES[variant] = variant_structure_timed(variant, n)


def variant_ckpt(variant):
    return os.path.join(HERE, "models_tpu", dict(VARIANT_CKPTS)[variant], "best_model.ckpt")


def variant_band(variant, n, e0, e1, extra, device):
    """The variant's banded build of (e0, e1) on `device` with the
    structure `extra` (graphs/io.variant_structure, original ids), and for
    HCA its HcaBandData, as evaluate_real builds them."""
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.models.hca_banded import make_hca_band_data

    banded, perm, _ = build_banded_duplex(n, e0, e1, max_rank=0, device=device,
                                          weights=extra.get("weights"),
                                          node_feat=extra.get("node_feat"))
    hd = None
    if variant == "hca":
        hd = make_hca_band_data(extra["comm_id"], extra["n_comms"], extra["hca_feat"], perm,
                                banded.pad_n, device=device)
    return banded, hd


def variant_forward(variant, net, banded, hd, covered, precise=True, tf32=None):
    """The variant's banded Q forward as dismantle_greedy_banded runs it:
    the fused step on a spill-free build (not HCA), the dense layers at the
    mode's matmul precision (TF32 for the fast mode), or in f32 with
    tf32=False."""
    from mdcommunity_tpu_torch.models.hca_banded import banded_hca_forward
    from mdcommunity_tpu_torch.models.net import banded_test_forward
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    with matmul_precision(not (tf32 if tf32 is not None else not precise)):
        if variant == "hca":
            return banded_hca_forward(net, banded, hd, covered, precise=precise)
        return banded_test_forward(net, banded, covered, fuse_sage=banded.spill_free,
                                   precise=precise, variant=variant)


def hold_q(label, q, ref, tol, within=None, shift=False):
    """A Q vector on the card against the CPU's: the same -inf, the same
    nodes selected (above eval/metrics.SENTINEL: every node of the base
    variants, HCA's selected ones), the selected nodes within tol of their
    max|ref| (and, with within = (t, f), a share f of them within t), and
    HCA's unselected nodes (-1e9·w) within tol relative.  The selected
    nodes' errors are read twice: as they are, and less the common shift
    (the median of q - ref over them), which moves every Q alike and so no
    pick of the greedy dismantler; shift=True holds the second reading.
    Returns the readings, in units of max|ref| over the selected nodes."""
    import numpy as np

    from mdcommunity_tpu_torch.eval.metrics import SENTINEL

    q, ref = q.double().cpu().numpy(), ref.double().cpu().numpy()
    fin = np.isfinite(ref)
    if not np.array_equal(np.isfinite(q), fin) or not fin.any():
        raise AssertionError(f"{label}: -inf masks differ")
    sel, sel_q = fin & (ref > SENTINEL), fin & (q > SENTINEL)
    low = fin & ~sel & ~sel_q
    scale = float(np.abs(ref[sel]).max()) if sel.any() else 1.0
    d = q[sel] - ref[sel] if sel.any() else np.zeros(1)
    c = float(np.median(d))
    out = dict(shift=c / scale)
    for key, e in (("", np.abs(d) / scale), ("_less_shift", np.abs(d - c) / scale)):
        out["err" + key] = float(e.max())
        if within:
            out["within" + key] = float(np.mean(e <= within[0]))
    rel_low = float((np.abs(q[low] - ref[low]) / np.abs(ref[low])).max()) if low.any() else 0.0
    agree = bool(np.array_equal(sel, sel_q))
    log(f"{label}: of max|Q| {scale:.3e}: max err {out['err']:.3e}"
        + (f", {out['within']:.4f} of the nodes within {within[0]:.0e}" if within else "")
        + f"; less the common shift {out['shift']:.3e}: max err {out['err_less_shift']:.3e}"
        + (f", {out['within_less_shift']:.4f} within" if within else "")
        + f"; selection the same on all {int(fin.sum())} live nodes {agree}, "
        f"unselected rel err {rel_low:.3e}")
    key = "_less_shift" if shift else ""
    if (not agree or out["err" + key] > tol or rel_low > tol
            or (within and out["within" + key] < within[1])):
        raise AssertionError(f"{label}: the card's forward disagrees with the CPU's")
    return out


def variant_path(device, variant, n, step_ratio, lockstep=VARIANT_LOCKSTEP):
    """One variant's large-graph dismantling on the main path's graph: its
    first forward on the card against the CPU's, precise and fast (HCA:
    relaunched, bit-equal), then evaluate_real(variant=...) with the counts
    set to 0 just before and read just after, its first `lockstep` model
    calls held to the CPU forward (Lockstep).  Returns (counts, result,
    the variant's structure: graphs/io.variant_structure)."""
    import torch

    from mdcommunity_tpu_torch.eval.real import evaluate_real
    from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops import hca_kernels as hk

    name = main_graph_file(n)
    path = os.path.join(OUT, name)
    raw = read_multiplex_edges(path, n)
    out = os.path.join(OUT, f"results_{variant}")
    extra, prior_s = STRUCTURES.pop(variant, None) or variant_structure_timed(variant, n)
    net = load_model(variant_ckpt(variant), device=device)
    # (precise, TF32 dense layers): the precise forward; the fast one as it
    # runs; the fast one with f32 dense layers, where only the order of the
    # f32 sums separates the card's bf16 kernels from their plain versions
    modes = ((True, False), (False, True), (False, False))
    qs, c_pad = {}, None
    for dev in (device, "cpu"):
        band, hd = variant_band(variant, n, raw[1], raw[2], extra, dev)
        net = net.to(dev)
        qs[dev] = [variant_forward(variant, net, band, hd, ~band.node_mask, p, t).cpu()
                   for p, t in modes]
        if dev == device and hd is not None:
            c_pad = hd.c_pad
            again = variant_forward(variant, net, band, hd, ~band.node_mask).cpu()
            if not torch.equal(again, qs[dev][0]):
                raise AssertionError("HCA forward relaunched: not bit-equal")
        del band, hd
    net = net.to(device)
    hold_q(f"{variant} first forward vs CPU", qs[device][0], qs["cpu"][0], 1e-4)
    # The fast forward at the fast rows' tolerances (fast_forward_phase).
    # CE is held less the shift common to its nodes: the Q head scales each
    # node's hidden term by the graph-level y_f . cross_product, which
    # cancels more in CE's model than in the others, so TF32's rounding of
    # y_f moves it by a few 1e-3 relative and every node's Q by nearly the
    # same amount, about 1e-2 of CE's max|Q|; a common shift changes no pick
    shift = variant == "ce"
    fast = dict(
        tf32=hold_q(f"{variant} fast first forward vs CPU, TF32 dense layers",
                    qs[device][1], qs["cpu"][1], FAST_Q_TOL, shift=shift),
        f32=hold_q(f"{variant} fast first forward vs CPU, f32 dense layers", qs[device][2],
                   qs["cpu"][2], FLIP_Q_TOL, (F32_Q_TOL, F32_Q_SHARE), shift=shift))

    step = max(int(step_ratio * n), 1)
    shadow = Lockstep(net, path, n, step, lockstep, variant, extra)
    stats = {}
    bk.reset_launches()
    hk.reset_launches()
    t0 = time.perf_counter()
    sol, solve_s, score = evaluate_real(
        net, OUT, name, out, n_nodes=n, layers=(1, 2), step_ratio=step_ratio,
        batch_env=True, blocked_threshold=0, device=device, engine="native",
        stats=stats, shadow=shadow, variant=variant)
    if device != "cpu":
        torch.cuda.synchronize()
    counts = {**bk.launches, **hk.launches}
    lock = shadow.summary()
    mean_fwd = 1e3 * stats["model_call_s"] / max(stats["model_calls"], 1)
    k12 = {k: v for k, v in counts.items() if v and k.startswith(("band_spmm", "band_sage"))}
    result = dict(variant=variant, n=n, step_ratio=step_ratio, audc=score, removed=len(sol),
                  solve_s=solve_s, wall_s=time.perf_counter() - t0,
                  model_calls=stats["model_calls"], mean_model_call_ms=mean_fwd,
                  prior_s=prior_s, prior_s_in_run=stats["prior_s"], c_pad=c_pad,
                  fuse_sage=stats["fuse_sage"], host_env=stats["host_env"],
                  lockstep_s=stats["shadow_s"], launches=k12, fast_first_forward=fast,
                  first_parting=lock["parting"])
    log(f"variant {variant}: " + json.dumps(result))
    if stats["host_env"] != "native":
        raise AssertionError("the variant paths must run the native host engine")
    if not (0.0 < score < 1.0) or not sol or len(set(sol)) != len(sol):
        raise AssertionError(f"{variant}: result out of range")
    if not all(0 <= v < n for v in sol):
        raise AssertionError(f"{variant}: solution ids out of range")
    tag = os.path.join(out, f"StepRatio_{step_ratio:.4f}")
    files = ["Soluion", "NormalizedLMCC"] + (["Cost"] if variant == "degree_cost" else [])
    for f in files:
        if not os.path.isfile(os.path.join(tag, f"{f}_synthetic_{n}_multiplex_12.txt")):
            raise AssertionError(f"{variant}: no {f} file")
    need = ("band_spmm", "hca_comm_adj") if variant == "hca" else ("band_spmm", "band_sage")
    if device != "cpu":
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {variant} path")
        if variant == "hca" and counts["band_sage"]:
            raise AssertionError("the HCA forward runs K1 only")
        if variant == "hca" and any(v for k, v in counts.items()
                                    if k.startswith("band_spmm_comm")):
            raise AssertionError("the HCA forward ran K1 on the one-hot membership")
    return counts, result, extra


def variant_small_phase(device, sizes=(32, 64, 128), n_graphs=5, n_valid=32):
    """Each variant's small-graph paths on the card against the CPU: the
    synthetic evaluation at `sizes` (n_graphs GMM graphs each, with the
    variant's structure) through evaluate_synthetic_generated, whose rows
    must be identical, and the validation VC of the committed checkpoint on
    the n_valid-graph pool, card within 1e-4 of the CPU.  Every variant runs
    before a failure raises.  Returns the VCs by variant."""
    import dataclasses

    from mdcommunity_tpu_torch.eval.synthetic import evaluate_synthetic_generated
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.rl.dqn import make_valid_pool, validate
    from mdcommunity_tpu_torch.utils.config import Config

    out, bad = {}, []
    for variant, _ in VARIANT_CKPTS:
        nets = [load_model(variant_ckpt(variant), device=d) for d in (device, "cpu")]
        t0 = time.perf_counter()
        rows = [evaluate_synthetic_generated(net, list(sizes), n_graphs=n_graphs,
                                             variant=variant, seed=0, device=d)
                for net, d in zip(nets, (device, "cpu"))]
        keys = ("score_mean", "score_std", "cost_mean")
        same = all(a[k] == b[k] for a, b in zip(*rows) for k in keys)
        for a, b in zip(*rows):
            log(f"{variant} synthetic row: " + json.dumps(dict(
                size=a["size"], score_mean=a["score_mean"], cpu_score_mean=b["score_mean"],
                score_std=a["score_std"], cpu_score_std=b["score_std"],
                cost_mean=a["cost_mean"], cpu_cost_mean=b["cost_mean"],
                time_mean_s=a["time_mean"])))
        log(f"{variant} synthetic rows: card = CPU {same}, {time.perf_counter() - t0:.2f} s")
        if not same:
            bad.append(f"{variant}: the synthetic rows on the card differ from the CPU's")

        cfg = dataclasses.replace(Config(variant=variant), n_valid=n_valid)
        vcs = [validate(net, make_valid_pool(cfg, device=d), variant)
               for net, d in zip(nets, (device, "cpu"))]
        out[variant] = dict(card=vcs[0], cpu=vcs[1])
        log(f"{variant} validation VC ({n_valid} graphs): " + json.dumps(out[variant]))
        if abs(vcs[0] - vcs[1]) > 1e-4:
            bad.append(f"{variant}: validation VC on the card is off the CPU's")
    if bad:
        raise AssertionError("; ".join(bad))
    return out


def comm_operands(dbg, n_comms, seed, device):
    """A one-hot membership [pad_n, n_comms] (a seeded community a node,
    padding rows 0) and live scales, the community pass's operands."""
    import torch

    g = torch.Generator().manual_seed(seed)
    cid = torch.randint(0, n_comms, (dbg.pad_n,), generator=g)
    onehot = torch.nn.functional.one_hot(cid, n_comms).float()
    live = (torch.rand(dbg.pad_n, generator=g) > 0.1).float()
    live[dbg.n:] = 0
    return onehot.to(device).contiguous(), live.to(device), cid


def check_comm_widths(device, banded, cpu_banded):
    """K1 at the community pass's widths on the main graph's 18,432 rows, in
    both precise modes: random operands at D = 128 and 256 against the
    plain version (REL_TOL), one-hot operands (integer sums) bit-equal to
    it, every launch twice for the same bits; and the community pass's K1
    form at c_pad = 512 (two K1 launches of 256 columns, community sums in a
    fixed order) on the card bit-equal to the CPU's plain pass (on
    cpu_banded, the same build on the CPU) and to a relaunch.  Returns the
    worst error by counter."""
    import torch

    from mdcommunity_tpu_torch.models.hca_banded import HcaBandData, community_graph
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub

    dbg, errs = banded.dbg0, {}
    for precise in (True, False):
        counter = "band_spmm_comm" if precise else "band_spmm_comm_bf16"
        for D in COMM_D:
            h, live = operands(dbg, D, 20 + D, device)
            oh, live_c, _ = comm_operands(dbg, D, 30 + D, device)
            for label, x, s in (("random", h, live), ("one-hot", oh, live_c)):
                sub = mirror_sub(dbg, s, x, precise)
                got = bk.spmm_band(dbg, s, s, x, sub, counter, precise)
                again = bk.spmm_band(dbg, s, s, x, sub, counter, precise)
                ref = bk.spmm_band_plain(dbg, s, s, x, sub, precise)
                if not torch.equal(got, again):
                    raise AssertionError(f"K1 D={D} relaunched: not bit-equal")
                err = compare(f"K1 D={D} {label} precise={precise}", got, ref)
                if label == "one-hot" and err:
                    raise AssertionError(f"K1 D={D} on a one-hot operand is not exact")
                errs[counter] = max(errs.get(counter, 0.0), err)
        # the chunked pass at c_pad = 512, card against the CPU's plain pass
        _, live, cid = comm_operands(dbg, 500, 40, "cpu")
        order = torch.argsort(cid, stable=True)
        lengths = torch.bincount(cid, minlength=512)

        def data(dev):
            return HcaBandData(comm_id=torch.stack([cid, cid]).to(dev), n_comms=(500, 500),
                               hca_feat=torch.zeros(dbg.pad_n, 3, device=dev), c_pad=512,
                               order=torch.stack([order, order]).to(dev),
                               lengths=torch.stack([lengths, lengths]).to(dev))

        ref = community_graph(cpu_banded, data("cpu"), 0, live, precise)
        got = community_graph(banded, data(device), 0, live.to(device), precise)
        again = community_graph(banded, data(device), 0, live.to(device), precise)
        if not (torch.equal(got.cpu(), ref) and torch.equal(got, again)):
            raise AssertionError(f"K1 form at c_pad=512 (precise={precise}): "
                                 "not bit-equal to the plain pass or to a relaunch")
        log(f"check K1 form c_pad=512 precise={precise}: bit-equal to the CPU's "
            f"plain pass and to a relaunch ({int(ref.sum().item())} live directed edges)")
    return errs


def check_comm_pass(device, banded, cpu_banded):
    """The community pass (ops/hca_kernels.comm_adj) at c_pad = 512 on both
    layers of the main graph's 18,432 rows, 10% of the nodes covered, with
    seeded and with arc communities (every edge across, most edges inside):
    on the card bit-equal to the K1 form on the card, (community_graph > 0)
    with the diagonal set to the real communities, to the CPU's plain pass
    and to a relaunch."""
    import torch

    from mdcommunity_tpu_torch.models.hca_banded import HcaBandData, community_graph
    from mdcommunity_tpu_torch.ops import hca_kernels as hk

    pad_n, n_real, c_pad = banded.pad_n, 500, 512
    live_f = comm_operands(banded.dbg0, 1, 50, "cpu")[1]
    live = live_f > 0
    eye = torch.eye(c_pad, device=device)
    real = (torch.arange(c_pad, device=device) < n_real).float()
    arcs = torch.arange(pad_n) * n_real // pad_n
    seeded = torch.randint(0, n_real, (pad_n,), generator=torch.Generator().manual_seed(51))
    for label, cid in (("seeded", seeded), ("arcs", arcs)):
        order = torch.argsort(cid, stable=True)
        lengths = torch.bincount(cid, minlength=c_pad)
        hd = HcaBandData(comm_id=torch.stack([cid, cid]).to(device), n_comms=(n_real, n_real),
                         hca_feat=torch.zeros(pad_n, 3, device=device), c_pad=c_pad,
                         order=torch.stack([order, order]).to(device),
                         lengths=torch.stack([lengths, lengths]).to(device))
        for layer in range(2):
            args = (hd.comm_id[layer], live.to(device), n_real, c_pad)
            got = hk.comm_adj(banded.dbg(layer), *args)
            again = hk.comm_adj(banded.dbg(layer), *args)
            k1 = (community_graph(banded, hd, layer, live_f.to(device)) > 0).float()
            k1 = k1 * (1.0 - eye) + eye * real[:, None]
            plain = hk.comm_adj_plain(cpu_banded.dbg(layer), cid, live, n_real, c_pad)
            if not (torch.equal(got, k1) and torch.equal(got.cpu(), plain)
                    and torch.equal(got, again)):
                raise AssertionError(f"community pass ({label}, layer {layer}): not bit-equal "
                                     "to the K1 form, the plain pass or a relaunch")
            log(f"check community pass c_pad=512 {label} layer {layer}: bit-equal to the K1 "
                f"form, the CPU's plain pass and a relaunch "
                f"({int(got.sum().item()) - n_real} inter-community pairs)")


def comm_bound_ms(dbg, c_pad, store_bytes=4):
    """Least time of one community pass: each byte read once (the band
    rows at their stored width, the mirror map, the mirror and spill COOs'
    edges and weights, comm_id and live) and the table written once, at the
    card's memory rate."""
    pitch = dbg.W2 // 2 if dbg.nibble else dbg.W2
    byts = (dbg.n_blocks * dbg.S * pitch + dbg.mirror_node.numel() * 8
            + (dbg.ccoo.nnz + dbg.spill.nnz) * 20 + dbg.pad_n * 9
            + c_pad * c_pad * store_bytes)
    return 1e3 * byts / PEAK_BYTES_S


def time_comm(device, dbg, cid, n_real, c_pad, label, random_cid=None):
    """The community pass (ops/hca_kernels.comm_adj) on one layer, every
    real node live: ms (CUDA events) and device ms beside its plain version
    (PyTorch on the same tensors) and its bound (comm_bound_ms); checked
    bit-equal to the plain version.  With random_cid, the device ms of the
    same pass under those communities too (nearly every edge a store)."""
    import torch

    from mdcommunity_tpu_torch.ops import hca_kernels as hk

    live = torch.zeros(dbg.pad_n, dtype=torch.bool, device=cid.device)
    live[:dbg.n] = True
    kern = lambda: hk.comm_adj(dbg, cid, live, n_real, c_pad)  # noqa: E731
    plain = lambda: hk.comm_adj_plain(dbg, cid, live, n_real, c_pad)  # noqa: E731
    got, ref = kern(), plain()
    if not torch.equal(got, ref):
        raise AssertionError(f"{label} community pass: not bit-equal to its plain version")
    err = (got - ref).abs().max().item()
    del got, ref
    res = dict(ms=time_ms(kern), device_ms=device_time_ms(kern), plain_ms=time_ms(plain),
               bound_ms=comm_bound_ms(dbg, c_pad), bound_by="bytes", library_ms=None,
               library_device_ms=None, max_abs_err=err, c_pad=c_pad, n_real=n_real,
               rows=dbg.pad_n, nibble=dbg.nibble)
    if random_cid is not None:
        res["device_ms_random_cid"] = device_time_ms(
            lambda: hk.comm_adj(dbg, random_cid, live, n_real, c_pad))
    log(f"time {label} hca_comm_adj: pad_n={dbg.pad_n} C={dbg.C} " + json.dumps(res))
    return res


def variant_phase(device, n=18222, step_ratio=0.001, lockstep=VARIANT_LOCKSTEP,
                  small=None, big=None):
    """Slice D1's phase: the three variants' large-graph dismantlings
    (variant_path), K1 at the community pass's widths (check_comm_widths),
    the community pass checked (check_comm_pass) and timed on the HCA path's
    structure (time_comm) and, given the 2^20-row build `big`, at its rows
    with c_pad 4,096 (3,191 arc communities, as Louvain's count on the
    benchmark's graph), and the small-graph paths (variant_small_phase;
    `small` its keyword arguments).  Returns (counts by variant, results by
    variant, the community pass's row: its 2^20 numbers under "2^20")."""
    import torch

    from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges

    counts, results, extras = {}, {}, {}
    for variant, _ in VARIANT_CKPTS:
        t0 = time.perf_counter()
        counts[variant], results[variant], extras[variant] = variant_path(
            device, variant, n, step_ratio, lockstep)
        log(f"variant phase: the {variant} path took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    extra = extras["hca"]
    raw = read_multiplex_edges(os.path.join(OUT, main_graph_file(n)), n)
    band, hd = variant_band("hca", n, raw[1], raw[2], extra, device)
    cpu_band = variant_band("hca", n, raw[1], raw[2], extra, "cpu")[0]
    comm = time_comm(device, band.dbg0, hd.comm_id[0], hd.n_comms[0], hd.c_pad,
                     f"{band.pad_n:,} rows")
    check_comm_widths(device, band, cpu_band)
    check_comm_pass(device, band, cpu_band)
    del band, hd, cpu_band
    if big is not None:
        pad_n, n_real = big.pad_n, 3191
        arcs = (torch.arange(pad_n, device=big.device) * n_real) // big.n_nodes
        rand = torch.randint(0, n_real, (pad_n,), device=big.device,
                             generator=torch.Generator(big.device).manual_seed(52))
        comm["2^20"] = time_comm(device, big.dbg0, arcs.clamp(max=n_real - 1), n_real, 4096,
                                 f"{pad_n:,} rows", random_cid=rand)
    log(f"variant phase: the community pass took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    variant_small_phase(device, **(small or {}))
    log(f"variant phase: the small graphs took {time.perf_counter() - t0:.1f} s")
    log("variant paths: " + json.dumps({v: dict(audc=r["audc"], removed=r["removed"])
                                        for v, r in results.items()}))
    return counts, results, comm


# ---------------------------------------------------------------- the variants' training

VT_ITERS = 101         # CE's and HCA's small-graph runs: validations at 0 and 100
VT_MORE = 5            # the resumed runs' iterations
# the small-graph runs keep Config()'s width (D = 64, batch 64, 32 envs,
# 30-50-node graphs) with smaller pools and warm-up than a 31k-iteration run
# needs: 200 training and 100 validation graphs, 2 warm-up games of 100
# episodes
VT_POOLS = dict(n_train=200, n_valid=100, warmup_games=2)
VT_ROLLOUT_STEPS = 8   # eps = 0 steps held card against CPU (one rollout chunk)
VT_BANDED_ITERS = 6    # the banded loops' iterations (target_update 3)
VT_CE_K = 256          # actions an iteration of CE's banded loop at 18,222 nodes


def _to_device(x, device):
    """A copy of x, a tensor or a dataclass of them (nested), on `device`."""
    import dataclasses

    import torch

    if torch.is_tensor(x):
        return x.to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _to_device(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def rollout_hold(device, agent, steps=VT_ROLLOUT_STEPS):
    """`steps` one-step chunks of rollout_autoreset at eps = 0 from the
    trained agent's env vector, with the agent's own flags (CE: ce_prune;
    HCA: hca_bridge with its beta and tau), on `device` and on the CPU from
    the same nets, states and generator seed: identical actions, and
    rewards (the bridge bonus included) within 1e-6 relative, up to the
    first step whose actions differ, which must be a near-tie (near_tie on
    the variant's Q, pruned for CE).  Returns (steps held, the parting or
    None)."""
    import copy

    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.env import prune_q_to_boundary
    from mdcommunity_tpu_torch.rl.dqn import fetch_history, predict_q, rollout_autoreset

    c = agent.cfg
    if agent._env_state is None:
        agent._reset_envs()
    pool = agent.train_pool
    kw = dict(gid_lo=pool.base, gid_hi=pool.base + pool.pool_size, n_steps=1,
              variant=c.variant, degree_cost=agent.degree_cost,
              ce_prune=c.variant == "ce" and c.action_pruning_train,
              hca_bridge=c.variant == "hca" and c.hca_bridge_effective,
              hca_beta=c.hca_beta, hca_tau=c.hca_tau)
    side = {}
    for dev in (device, "cpu"):
        side[dev] = dict(
            net=copy.deepcopy(agent.net).to(dev), pool_g=_to_device(pool.stacked, dev),
            pool_s0=_to_device(pool.stacked_s0, dev),
            carry=(torch.as_tensor(agent._env_gids, device=dev),
                   _to_device(agent._env_graphs, dev), _to_device(agent._env_state, dev)),
            gen=torch.Generator().manual_seed(17))
    parting = None
    for step in range(steps):
        out = {}
        for dev, sd in side.items():
            carry, hist = rollout_autoreset(sd["net"], sd["pool_g"], sd["pool_s0"],
                                            *sd["carry"], sd["gen"], 0.0, **kw)
            out[dev] = (carry, fetch_history(hist, carry[0])[0])
        hd, hc = out[device][1], out["cpu"][1]
        if not np.array_equal(hd["actions"], hc["actions"]):
            qs = []
            for dev in (device, "cpu"):
                gg, ss = side[dev]["carry"][1:]
                q = predict_q(side[dev]["net"], gg, ss.covered, ss.sever, c.variant)
                if kw["ce_prune"]:
                    q = prune_q_to_boundary(q, gg.boundary)
                qs.append(q.double().cpu().numpy())
            b = int(np.flatnonzero(hd["actions"][0] != hc["actions"][0])[0])
            x, y = int(hd["actions"][0, b]), int(hc["actions"][0, b])
            parting = dict(step=step, env=b, card_takes=x, cpu_takes=y,
                           q_card=[qs[0][b, x], qs[0][b, y]], q_cpu=[qs[1][b, x], qs[1][b, y]],
                           tie=near_tie(qs[0][b], qs[1][b], x, y))
            log(f"{c.variant} rollout, card vs CPU: first parting " + json.dumps(parting))
            if not parting["tie"]:
                raise AssertionError(f"the {c.variant} rollout parts from the CPU's on a "
                                     "decision that is not a near-tie")
            break
        for k in ("covered", "sever", "valid", "done", "gid"):
            if not np.array_equal(hd[k], hc[k]):
                raise AssertionError(f"the {c.variant} rollout's {k} differs from the CPU's")
        if not np.allclose(hd["rewards"], hc["rewards"], rtol=1e-6, atol=0):
            raise AssertionError(f"the {c.variant} rollout's rewards differ from the CPU's")
        for dev in side:
            side[dev]["carry"] = out[dev][0]
    else:
        step = steps
    flags = {k: v for k, v in kw.items() if k in ("ce_prune", "hca_bridge")}
    log(f"{c.variant} rollout (eps = 0, {json.dumps(flags)}): "
        f"{step} steps of {len(agent._env_gids)} envs identical on the card and the CPU"
        + ("" if parting is None else ", then a near-tie parting"))
    return step, parting


def banded_loop_hold(device, variant, net, banded, edges, k, weights=None,
                     iters=VT_BANDED_ITERS):
    """train_banded_loop(variant=) for `iters` iterations (target_update 3)
    on `banded` (its host env with the band-order `weights` for degree
    cost), counts set to 0 just before and read just after: finite fitted
    losses, moved parameters, env.t equal to the removals the loop counted,
    band_spmm and band_spmm_bwd launched, and band_sage where the build is
    spill-free.  The first fit's loss on the card is held to the CPU's plain
    loss on the same state (its operands, covered mask, actions and
    targets copied there) within 1e-5 of the loss's terms before they
    cancel.  The loss is mean((Q - t)²) + α·reg: where Q - t is a few
    percent of |Q| (4% on the degree-cost state at 2^20 nodes) an error δ
    relative in Q moves the first part by 2·rms(t)·sqrt(mse)·δ, and reg
    is Σ_l 2(quad_l - cross_l)/|E_l| with quad_l/|E_l| ≤ 1 (unit rows), a
    difference of terms up to 4 in all.  So the loss is held to 1e-5·(2·
    rms(t)·sqrt(loss) + 4α) absolute (mse ≤ loss), the f32 error of those
    terms with room (1e-5 of the loss itself would fail on the f32
    kernels' own rounding where the loss cancels).  On the card the
    same first loss is also taken at two lower precisions, the controls:
    the band operator in K1's bf16 mode (precise=False) and the dense
    layers in TF32 (matmul_precision(False)); each must land outside the
    bound, so that the bound tells an f32 fit from either.  Their launches
    are taken back out of the counts.  Returns (counts, readings)."""
    import copy

    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.rl import big_trainer
    from mdcommunity_tpu_torch.utils.device import matmul_precision

    on_card = device != "cpu"
    env = make_host_env(banded.n_nodes, *edges, weights=weights, engine="native")
    real = big_trainer.banded_train_loss
    first = {}

    def loss_hold(net_, bdx, covered, actions, targets, **kw):
        loss = real(net_, bdx, covered, actions, targets, **kw)
        if not first:
            t0 = time.perf_counter()
            with torch.no_grad():
                ref = real(copy.deepcopy(net_).cpu(), _to_device(bdx, "cpu"), covered.cpu(),
                           actions.cpu(), targets.cpu(), **dict(kw, remat=False))
            rms_t = targets.double().square().mean().sqrt().item()
            terms = 2.0 * rms_t * math.sqrt(ref.item()) + 4.0 * kw.get("alpha", 1e-3)
            first.update(card=loss.item(), cpu=ref.item(), terms=terms,
                         cpu_s=time.perf_counter() - t0, controls={})
            if on_card:
                counted = dict(bk.launches)
                with torch.no_grad():
                    first["controls"]["bf16_band"] = real(
                        net_, bdx, covered, actions, targets, **dict(kw, precise=False)).item()
                    with matmul_precision(False):
                        first["controls"]["tf32_dense"] = real(
                            net_, bdx, covered, actions, targets, **kw).item()
                bk.launches.update(counted)
        return loss

    big_trainer.banded_train_loss = loss_hold
    try:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        bk.reset_launches()
        t0 = time.perf_counter()
        net2, hist = big_trainer.train_banded_loop(net, banded, env, iters=iters, k=k,
                                                   target_update=3, variant=variant,
                                                   log=log, log_every=iters)
        if on_card:
            torch.cuda.synchronize()
        counts = dict(bk.launches)
        wall = time.perf_counter() - t0
    finally:
        big_trainer.banded_train_loss = real
    rows = [h for h in hist if "loss" in h]
    fitted = [h for h in rows if h["removed"] == k]
    rel = abs(first["card"] - first["cpu"]) / abs(first["cpu"]) if first else float("nan")
    tol = 1e-5 * first["terms"] / abs(first["cpu"]) if first else float("nan")
    controls = {k: abs(v - first["cpu"]) / abs(first["cpu"])
                for k, v in first.get("controls", {}).items()}
    res = dict(variant=variant, pad_n=banded.pad_n, k=k, wall_s=wall,
               fit_ms=1e3 * float(np.median([h["t_fit_s"] for h in fitted[1:]]))
               if len(fitted) > 1 else None,
               iter_p50_s=float(np.median([h["t_iter_s"] for h in rows])),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
               losses=[h["loss"] for h in rows], first_fit=first, first_fit_rel=rel,
               first_fit_tol=tol, first_fit_controls_rel=controls,
               launches={c: v for c, v in counts.items() if v})
    log(f"banded loop ({variant}): " + json.dumps(res))
    if not fitted or not np.isfinite([h["loss"] for h in fitted]).all():
        raise AssertionError(f"the {variant} loop did not fit full batches to a finite loss")
    if not sum((a - b.detach()).abs().sum().item()
               for a, b in zip(net.parameters(), net2.parameters())) > 0:
        raise AssertionError(f"the {variant} loop did not move the parameters")
    if env.t != sum(h["removed"] for h in rows):
        raise AssertionError(f"the {variant} loop's env.t differs from its removals")
    if not rel <= tol:
        raise AssertionError(f"the {variant} loop's first fit differs from the CPU's loss")
    for name, r in controls.items():
        if not r > tol:
            raise AssertionError(f"the {variant} first fit's bound does not tell the f32 fit "
                                 f"from the {name} control")
    want = ["band_spmm", "band_spmm_bwd"] + (["band_sage"] if banded.spill_free else [])
    for name in want:
        if on_card and counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the {variant} loop")
    return counts, res


def live_scales_hold(device, dbg):
    """live_scales(mean|gcn) on the card against its plain version on the
    CPU, in both precise modes: its live-degree pass is K1 at D = 1, on 0/1
    operands with integer sums, so the scales are bit-equal.  Counts set to
    0 just before each call and read just after.  Returns the counts."""
    import torch

    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import live_scales

    g = torch.Generator().manual_seed(21)
    covered = torch.rand(dbg.pad_n, generator=g) < 0.1
    covered[dbg.n:] = True
    cpu = _to_device(dbg, "cpu")
    total = dict.fromkeys(bk.launches, 0)
    for agg in ("mean", "gcn"):
        for precise in (True, False):
            bk.reset_launches()
            got = live_scales(dbg, covered.to(dbg.device), agg, precise)
            counts = dict(bk.launches)
            ref = live_scales(cpu, covered, agg, precise)
            same = all(torch.equal(a.cpu(), b) for a, b in zip(got, ref))
            name = "band_spmm" if precise else "band_spmm_bf16"
            log(f"live_scales({agg}, precise={precise}) at pad_n={dbg.pad_n}: card = CPU "
                f"{same}, {name} launches {counts[name]}")
            if not same:
                raise AssertionError(f"live_scales({agg}) on the card differs from the CPU's")
            if dbg.device.type == "cuda" and counts[name] <= 0:
                raise AssertionError(f"live_scales({agg}) did not launch {name}")
            total = {c: total[c] + counts[c] for c in total}
    return total


def variant_train_phase(device, big, big_edges, k, n=18222, iters=VT_ITERS, more=VT_MORE,
                        cfg=None, gp=GP, shard_iters=3):
    """Slice D2's phase, the variants' training: CE's and HCA's small-graph
    runs at `cfg` (Config()'s full width; dqn_phase, each with its resume
    and its card-vs-CPU train_step), one eps = 0 rollout chunk of each on
    the card against the CPU (rollout_hold), the degree-cost banded loop on
    `big` with degree weights and the CE banded loop on the main path's
    graph with its prior (banded_loop_hold), degree cost at gp shards beside
    the unsharded loop (sharded_trainer_phase), and live_scales on the main
    path's graph (live_scales_hold).  Returns (launch counts by path,
    readings)."""
    import dataclasses

    import numpy as np
    import torch

    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.graphs.gmm import _degree_weights
    from mdcommunity_tpu_torch.graphs.io import read_multiplex_edges
    from mdcommunity_tpu_torch.models.checkpoint import load_model
    from mdcommunity_tpu_torch.utils.config import Config

    readings, counts = {}, {}
    for variant in ("ce", "hca"):
        t0 = time.perf_counter()
        c = cfg or Config(save_frequency=iters - 1, **VT_POOLS)
        readings[variant], agent = dqn_phase(device, c, iters, more, variant=variant)
        readings[variant]["rollout"] = rollout_hold(device, agent)
        log(f"variant training: the {variant} small-graph run took "
            f"{time.perf_counter() - t0:.1f} s")
        del agent

    # degree cost on `big`: deg/maxdeg weights of its (band-order) edges
    t0 = time.perf_counter()
    n_big = big.n_nodes
    w = _degree_weights(n_big, *big_edges)
    w_pad = np.ones((2, big.pad_n), np.float32)
    w_pad[:, :n_big] = w
    big_dc = dataclasses.replace(big, weights=torch.from_numpy(w_pad).to(big.device))
    net_dc = load_model(variant_ckpt("degree_cost"), device=device)
    counts["degree_cost"], readings["degree_cost_loop"] = banded_loop_hold(
        device, "degree_cost", net_dc, big_dc, big_edges, k, weights=w)
    counts["degree_cost_gp"] = sharded_trainer_phase(
        device, big_dc, big_edges, k, gp=gp, iters=shard_iters, variant="degree_cost",
        ckpt=variant_ckpt("degree_cost"), weights=w)
    if device != "cpu":
        for name in ("band_halo", "band_halo_bwd"):
            if counts["degree_cost_gp"][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by the sharded "
                                     "degree-cost loop")
    del big_dc
    log(f"variant training: the degree-cost loops took {time.perf_counter() - t0:.1f} s")

    # CE on the main path's graph, with the prior the variants' phase made
    t0 = time.perf_counter()
    extra = STRUCTURES["ce"][0] if "ce" in STRUCTURES else variant_structure_timed("ce", n)[0]
    raw = read_multiplex_edges(os.path.join(OUT, main_graph_file(n)), n)
    banded_ce, _, edges_ce = build_banded_duplex(n, raw[1], raw[2], max_rank=0, device=device,
                                                 node_feat=extra["node_feat"])
    counts["ce"], readings["ce_loop"] = banded_loop_hold(
        device, "ce", load_model(variant_ckpt("ce"), device=device), banded_ce, edges_ce,
        min(VT_CE_K, n // 64))
    counts["live_scales"] = live_scales_hold(device, banded_ce.dbg0)
    del banded_ce
    log(f"variant training: the CE loop and live_scales took "
        f"{time.perf_counter() - t0:.1f} s")
    log("variant training launches: " + json.dumps(
        {p: {c: v for c, v in cs.items() if v} for p, cs in counts.items()}))
    return counts, readings


# ------------------------------------------------ phase 14: baselines and tools

BAND_S, BAND_B, BAND_D = 512, 256, 64   # spmm_band on the main path's graph
SPMM_BAND_TOL = 1e-6                     # of max|ref| against float64 on the CPU
PARTITION_GP = 4
PARTITION_TOL = 1e-6                     # of max|ref| against the unsharded sum


def _baseline_json(argv):
    """The JSON line cli.main(argv) prints."""
    import contextlib
    import io

    from mdcommunity_tpu_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def heuristic_golden(device, sizes=(32, 64, 128)):
    """The degree_max2 and ci_max2 rows of golden.json on `device`
    (scripts/make_golden_synthetic.py's seeds: default_rng(SEED + n) a size,
    graphs of LMCC 1 skipped), each within rtol 1e-5."""
    import numpy as np

    from mdcommunity_tpu_torch.eval.baselines import heuristic_dismantle
    from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges
    from mdcommunity_tpu_torch.graphs.io import duplex_from_layers

    with open(GOLDEN_SYN) as f:
        golden = json.load(f)
    for key, method, combine in (("degree_max2", "degree", "max2"), ("ci_max2", "ci", "max2")):
        for want in golden[key]:
            n = want["size"]
            if n not in sizes:
                continue
            rng = np.random.default_rng(golden["seed"] + n)
            scores, costs = [], []
            for _ in range(golden["n_graphs"]):
                e0, e1 = gmm_duplex_edges(n, rng)
                g = duplex_from_layers(n, e0, e1, device=device)
                if int(g.max_rank) <= 1:
                    continue
                sol, score, _ = heuristic_dismantle(g, method, combine)
                scores.append(score)
                costs.append(len(sol) / n)
            got = dict(score_mean=float(np.mean(scores)), score_std=float(np.std(scores)),
                       cost_mean=float(np.mean(costs)))
            log(f"golden {key} n={n}: " + json.dumps(got))
            for k, v in got.items():
                if not math.isclose(v, want[k], rel_tol=1e-5, abs_tol=0.0):
                    raise AssertionError(f"golden {key} n={n} {k}: {v} against {want[k]}")


def heuristics_card_vs_cpu(device, n=64, n_graphs=2):
    """All five methods x both combines, plain, with protect_frac = 0.05 and
    with the _syn stop, on n_graphs seeded GMM graphs: the card's solutions
    and scores identical to the CPU's.  Returns the seconds on the card."""
    import numpy as np

    from mdcommunity_tpu_torch.eval.baselines import COMBINES, METHODS, heuristic_dismantle
    from mdcommunity_tpu_torch.graphs.gmm import gmm_duplex_edges
    from mdcommunity_tpu_torch.graphs.io import duplex_from_layers

    rng = np.random.default_rng(1)
    pairs = []
    while len(pairs) < n_graphs:
        e0, e1 = gmm_duplex_edges(n, rng)
        g = duplex_from_layers(n, e0, e1, device="cpu")
        if int(g.max_rank) > 1:
            pairs.append((duplex_from_layers(n, e0, e1, device=device), g))
    card_s, runs, bad = 0.0, 0, []
    for method in METHODS:
        for combine in COMBINES:
            for kw in (dict(), dict(protect_frac=0.05), dict(syn_stop=True)):
                for gc, gh in pairs:
                    t0 = time.perf_counter()
                    got = heuristic_dismantle(gc, method, combine, **kw)
                    card_s += time.perf_counter() - t0
                    want = heuristic_dismantle(gh, method, combine, **kw)
                    runs += 1
                    if got != want:
                        bad.append(f"{method}/{combine} {kw}")
    log(f"heuristics card vs CPU: {runs} runs at n = {n}, {len(bad)} differ, "
        f"card {card_s:.2f} s")
    if bad:
        raise AssertionError("heuristics differ between the card and the CPU: "
                             + ", ".join(bad))
    return card_s


def baseline_cli(device, out_dir, size=1024, n_graphs=2):
    """`cli baseline` for degree and CI at `size` nodes on the card and with
    --cpu: identical JSON lines; the seconds a graph's dismantling takes
    (the time&audc files' time column, which both runs write with -o; the
    card's files feed the analyze check)."""
    import csv

    files, per_graph = {}, {}
    for method in ("degree", "ci"):
        argv = ["baseline", "--method", method, "--size", str(size),
                "--n-graphs", str(n_graphs)]
        secs = []
        for dev, sub in ((["--cpu"] if device == "cpu" else [], method), (["--cpu"], "cpu")):
            path = os.path.join(out_dir, sub, f"time&audc_{method}.csv")
            line = _baseline_json(argv + dev + ["-o", path])
            with open(path, newline="") as f:
                secs.append([float(r["time"]) for r in csv.DictReader(f)])
            if sub == method:
                got, files[method] = line, path
            else:
                want = line
        per_graph[method] = sum(secs[0]) / len(secs[0])
        log(f"baseline {method} n={size}: " + json.dumps(dict(
            got, cpu_score_mean=want["score_mean"], card_s_per_graph=secs[0],
            cpu_s_per_graph=secs[1])))
        if got != want:
            raise AssertionError(f"baseline {method}: the card's line {got} differs from "
                                 f"the CPU's {want}")
    return files, per_graph


def tools_check(out_dir, files):
    """analyze on the baseline runs' time&audc files, summarize-edges on a
    written .edges directory, and draw (a PNG where matplotlib is present;
    where it is absent, an ImportError that names it)."""
    import contextlib
    import csv
    import importlib.util
    import io

    import numpy as np

    from mdcommunity_tpu_torch.cli import main as cli
    from mdcommunity_tpu_torch.eval.writers import write_lmcc_curve
    from mdcommunity_tpu_torch.large_graph_demo import write_edges

    report = os.path.join(out_dir, "report.csv")
    cli(["analyze", "--unitcost", files["degree"], "--community", files["ci"],
         "-o", report])
    with open(report, newline="") as f:
        rows = list(csv.DictReader(f))
    reads = []
    for name in ("degree", "ci"):
        with open(files[name], newline="") as f:
            reads.append({r["dataset"]: r for r in csv.DictReader(f)})
    if not rows or [r["dataset"] for r in rows] != sorted(reads[0]):
        raise AssertionError(f"analyze: rows {[r['dataset'] for r in rows]}")
    for r in rows:
        u, c = (float(x[r["dataset"]]["audc"]) for x in reads)
        if not math.isclose(float(r["audc_delta_pct"]), (c - u) / u * 100.0, rel_tol=1e-12):
            raise AssertionError(f"analyze: {r}")
    log(f"analyze: {len(rows)} rows, audc_delta_pct "
        + ", ".join(r["audc_delta_pct"] for r in rows))

    edges_dir = os.path.join(out_dir, "edges")
    os.makedirs(edges_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    e0, e1 = (rng.integers(0, 50, (120, 2)) for _ in range(2))
    write_edges(os.path.join(edges_dir, "toy.edges"), e0, e1)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(["summarize-edges", "--data", edges_dir, "-o", os.path.join(out_dir, "s.csv")])
    fields = out.getvalue().splitlines()[1].split("\t")
    want_n = int(max(e0.max(), e1.max())) + 1  # the .edges ids are 1-based
    if fields[:3] != ["toy", str(want_n), "2"]:
        raise AssertionError(f"summarize-edges: {fields}")
    log("summarize-edges: " + " ".join(fields))

    lmcc = os.path.join(out_dir, "lmcc.txt")
    write_lmcc_curve(lmcc, [1.0, 0.6, 0.3, 0.1], 6, 10, 0.2, 0.01)
    png = os.path.join(out_dir, "lmcc.png")
    if importlib.util.find_spec("matplotlib") is None:
        try:
            cli(["draw", f"model={lmcc}", "-o", png])
        except ImportError as exc:
            if "matplotlib" not in str(exc):
                raise AssertionError(f"draw raised without naming matplotlib: {exc}")
            log(f"draw: matplotlib absent, raised: {exc}")
        else:
            raise AssertionError("draw ran without matplotlib")
    else:
        cli(["draw", f"model={lmcc}", "-o", png])
        if not os.path.getsize(png):
            raise AssertionError("draw wrote an empty PNG")
        log(f"draw: wrote {os.path.getsize(png)} bytes")


def model_vs_heuristics_check(device, sizes=(64,), n_graphs=3):
    """model_vs_heuristics' rows on the card equal to the CPU's."""
    from mdcommunity_tpu_torch import model_vs_heuristics as mvh
    from mdcommunity_tpu_torch.models.torch_convert import load_any_model

    rows = [mvh.run(load_any_model(mvh.MODEL, device=d), list(sizes), n_graphs, device=d)
            for d in (device, "cpu")]
    log("model_vs_heuristics: " + json.dumps(dict(card=rows[0], cpu=rows[1])))
    if rows[0] != rows[1]:
        raise AssertionError("model_vs_heuristics: the card's rows differ from the CPU's")


def _band_case(edges, n, device, S, B, D, seed):
    """spmm_band's operands on one layer's ordered edges (both directions,
    one seeded weight an undirected edge), on `device`."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.ops.band_spmm import band_weights, build_band

    rng = np.random.default_rng(seed)
    w0 = rng.random(len(edges)).astype(np.float32)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = np.concatenate([w0, w0])
    bg, row, col, in_band = build_band(src, dst, n, S=S, B=B, device=device)
    wb = band_weights(bg, row, col, w[in_band])
    w_ov = torch.from_numpy(w[~in_band][np.argsort(dst[~in_band], kind="stable")]).to(device)
    h = torch.from_numpy(rng.standard_normal((bg.pad_n, D)).astype(np.float32)).to(device)
    ct = torch.from_numpy(rng.standard_normal((bg.pad_n, D)).astype(np.float32)).to(device)
    return bg, wb, w_ov, h, ct


def _band_fwd_bwd(bg, wb, w_ov, h, ct):
    import torch

    from mdcommunity_tpu_torch.ops.band_spmm import spmm_band

    args = [x.detach().requires_grad_() for x in (wb, w_ov, h)]
    out = spmm_band(bg, *args)
    grads = torch.autograd.grad((out * ct).sum(), args)
    return [out.detach(), *grads]


def spmm_band_check(device, banded, edges, S=BAND_S, B=BAND_B, D=BAND_D):
    """ops/band_spmm.spmm_band on layer 0 of the main path's graph in its
    locality order (a non-empty overflow): the forward and the gradients of
    the band weights, the overflow weights and h within SPMM_BAND_TOL of
    max|ref| of the same function in float64 on the CPU, two calls bit-equal;
    fwd+bwd ms beside BandSpmm's (K1 and its backward) on the same graph."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import spmm_dense_band_grad

    from mdcommunity_tpu_torch.utils.device import matmul_precision

    n = banded.n_nodes
    bg, wb, w_ov, h, ct = _band_case(edges, n, device, S, B, D, 0)
    if not bg.overflow.nnz:
        raise AssertionError("spmm_band: the main path's graph left no overflow")
    with matmul_precision(True):  # the block products in f32, no TF32
        got = _band_fwd_bwd(bg, wb, w_ov, h, ct)
        again = _band_fwd_bwd(bg, wb, w_ov, h, ct)
        ms = time_ms(lambda: _band_fwd_bwd(bg, wb, w_ov, h, ct))
    cbg = _band_case(edges, n, "cpu", S, B, D, 0)[0]
    ref = _band_fwd_bwd(cbg, *(x.cpu().double() for x in (wb, w_ov, h, ct)))
    errs = {}
    for name, a, b, r in zip(("out", "d_wb", "d_w_ov", "d_h"), got, again, ref):
        if not torch.equal(a, b):
            raise AssertionError(f"spmm_band {name}: two calls differ")
        err = (a.cpu().double() - r).abs().max().item()
        scale = r.abs().max().item()
        errs[name] = err / scale
        if not err <= SPMM_BAND_TOL * scale:
            raise AssertionError(f"spmm_band {name}: {err:.3e} against max|ref| {scale:.3e}")

    dbg = banded.dbg0
    live = torch.ones(dbg.pad_n, device=device)
    hk = torch.randn(dbg.pad_n, D, generator=torch.Generator().manual_seed(1)).to(device)
    ck = torch.randn_like(hk)

    def k1():
        x = hk.detach().requires_grad_()
        return torch.autograd.grad((spmm_dense_band_grad(dbg, live, live, x) * ck).sum(), x)

    k1_ms = time_ms(k1)
    log(f"spmm_band at {n} nodes (S = {S}, B = {B}, D = {D}, {bg.overflow.nnz} overflow "
        f"edges): fwd+bwd {ms:.3f} ms, BandSpmm (K1 + its backward) {k1_ms:.3f} ms; "
        "error against f64 of max|ref|: " + json.dumps({k: float(f"{v:.3e}")
                                                        for k, v in errs.items()}))
    return dict(ms=ms, k1_ms=k1_ms, **errs)


def partition_check(device, n, edges, gp=PARTITION_GP, D=BAND_D):
    """parallel/partition.spmm_edge_partitioned at gp shards (all on the one
    card) on a graph's directed edges (E padded to a multiple of gp): within
    PARTITION_TOL of max|ref| of the unsharded segment sum, two calls
    bit-equal; its ms beside the unsharded sum's."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.ops.aggregate import spmm_coo
    from mdcommunity_tpu_torch.parallel.mesh import make_mesh
    from mdcommunity_tpu_torch.parallel.partition import shard_edges, spmm_edge_partitioned

    rng = np.random.default_rng(2)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = rng.random(len(src)).astype(np.float32)
    pad = -len(src) % gp
    src, dst = (np.concatenate([x, np.zeros(pad, np.int64)]) for x in (src, dst))
    w = np.concatenate([w, np.zeros(pad, np.float32)])
    s, d, ww = (torch.from_numpy(x).to(device) for x in (src, dst, w))
    h = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(device)
    mesh = make_mesh(gp, device)
    parts = shard_edges(mesh, s, d, ww)
    got = spmm_edge_partitioned(mesh, *parts, h)[0]
    again = spmm_edge_partitioned(mesh, *parts, h)[0]
    if not torch.equal(got, again):
        raise AssertionError("spmm_edge_partitioned: two calls differ")
    ref = spmm_coo(s, d, ww, h, n)
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not err <= PARTITION_TOL * scale:
        raise AssertionError(f"spmm_edge_partitioned: {err:.3e} against max|ref| {scale:.3e}")
    ms = time_ms(lambda: spmm_edge_partitioned(mesh, *parts, h))
    whole_ms = time_ms(lambda: spmm_coo(s, d, ww, h, n))
    log(f"spmm_edge_partitioned at {n} nodes, {len(src)} directed edges, gp = {gp}, "
        f"D = {D}: {ms:.3f} ms (unsharded segment sum {whole_ms:.3f} ms), "
        f"error {err / scale:.3e} of max|ref|")
    return dict(ms=ms, whole_ms=whole_ms, rel_err=err / scale)


def baselines_phase(device, banded, edges, big_n, big_edges, small=False):
    """Phase 14: the heuristic baselines and the remaining eval tools
    (module docstring).  banded/edges: the main path's graph and its ordered
    edges; big_n/big_edges: the 2^20-node unshuffled graph's.  small=True is
    the rehearsal's size."""
    out_dir = os.path.join(OUT, "baselines")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    heuristic_golden(device, sizes=(32,) if small else (32, 64, 128))
    card_s = heuristics_card_vs_cpu(device, n=32 if small else 64,
                                    n_graphs=1 if small else 2)
    files, per_graph = baseline_cli(device, out_dir, size=64 if small else 1024)
    tools_check(out_dir, files)
    model_vs_heuristics_check(device, sizes=(32,) if small else (64,),
                              n_graphs=2 if small else 3)
    band = (spmm_band_check(device, banded, edges[0], S=128, B=64) if small
            else spmm_band_check(device, banded, edges[0]))
    part = partition_check(device, big_n, big_edges[0])
    log(f"baselines and tools: {time.perf_counter() - t0:.1f} s")
    return dict(heuristics_card_s=card_s, baseline_s_per_graph=per_graph,
                spmm_band=band, partition=part)


MP_N = 1 << 18            # phase 15's spill-free build (the 2^20 build's generator)
MP_K = 262                # actions a step of phase 15's loop (0.001 of the nodes)
MP_TIMEOUT = 420          # seconds for phase 15's children


def multiprocess_config(small=False):
    """Phase 15's run of mdcommunity_tpu_torch.multihost_smoke: two
    processes sharing the card, gp = 4 (two shards a process), every phase;
    small=True is the rehearsal's size on the CPU."""
    import dataclasses

    from mdcommunity_tpu_torch.utils.config import Config

    agent = dataclasses.replace(Config(), n_train=100, n_valid=64)
    cfg = dict(
        phases=["gp", "trainer", "dp_agent", "validate", "partition", "timing"],
        graph=dict(kind="synth", n=MP_N), precise=[True, False], actions=MP_K,
        shard_tol=SHARD_Q_TOL, k1_tol=0.0,
        unsharded_tol=dict(precise=SHARD_Q_TOL, fast=FAST_Q_TOL), ckpt=CKPT,
        rules=os.path.join(HERE, "tests", "gradient_rules.py"),
        trainer=dict(iters=3, k=MP_K, ckpt=CKPT_FIT, engine="native"),
        agent=dict(config=dict(n_train=agent.n_train, n_valid=agent.n_valid), fits=3,
                   warmup_games=1, warmup_traj=40),
        partition=dict(n=MP_N, edges=1 << 20, D=64, tol=PARTITION_TOL),
        timing=dict(calls=5))
    if small:
        cfg.update(graph=dict(kind="synth", n=2048), actions=16, shard_tol=0.0,
                   k1_tol=2.0 ** -7, trainer=dict(cfg["trainer"], k=16),
                   agent=dict(cfg["agent"], smoke=True,
                              config=dict(n_train=8, n_valid=4, batch_size=8)),
                   partition=dict(cfg["partition"], n=2048, edges=8192),
                   timing=dict(calls=2))
    return cfg


def multiprocess_phase(device, small=False):
    """Phase 15: the port across OS processes (module docstring).  Two
    children of mdcommunity_tpu_torch.multihost_smoke share the card over
    gloo, each holding two of gp = 4 shards of a spill-free 2^18-node build
    at the unit-cost checkpoint's width: the sharded operator (forward and
    VJP, precise and bf16 modes) against the one-process gp = 4 call within
    SHARD_Q_TOL of max (0 expected) and against K1 (0); Q, precise and fast,
    the same way and against the unsharded forward (SHARD_Q_TOL, FAST_Q_TOL);
    the loss and every gradient leaf against the one-process loss by
    tests/gradient_rules.py; 3 iterations of train_banded_loop(mesh=)
    against the one-process loop (the same removals, parameters bit-equal
    across the processes, K3's and its backward's launches counted in each
    child); DQNAgent(mesh=dp 2) at Config()'s width, 3 fits within 1e-5 of
    the single-process agent's losses, parameters bit-equal across the
    processes, and its validation against the single-process VC; the edge
    partition within PARTITION_TOL; and the cross-process model call's ms
    beside the one-process call's, with one halo exchange's and one mirror
    gather's (transport through the host under gloo, on one card; not
    NVLink).  The one-process references run in the first child, whose
    results the other's equal bit for bit (digests).  Every check raises in
    the child that makes it, and a child's non-zero exit raises here.  Returns each child's K3 launch counts
    (rank -> counter -> launches, over the gp phase's calls and the loop)."""
    from mdcommunity_tpu_torch import multihost_smoke as mh
    from mdcommunity_tpu_torch.utils.timing import gpu_line

    out = os.path.join(OUT, "multiprocess")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    results, output = mh.run(device, "gloo", multiprocess_config(small), out,
                             timeout=MP_TIMEOUT)
    for k, text in enumerate(output):
        for line in text.splitlines():
            if line.startswith("rank "):
                log(f"  [child {k}] {line}")
    mh.check_agreement(results)
    counts = {}
    for k, r in enumerate(results):
        c = dict(r["trainer"]["launches"])
        for key in ("op_precise", "op_fast", "q_precise", "q_fast"):
            for name, v in r["gp"][key]["launches"].items():
                c[name] = c.get(name, 0) + v
        counts[k] = c
        for name in ("band_halo", "band_halo_bwd", "band_halo_bf16", "band_halo_bf16_bwd"):
            if device != "cpu" and c.get(name, 0) <= 0:
                raise AssertionError(f"child {k} did not launch {name}")
    r0 = results[0]
    card = gpu_line() or "cpu"
    log("multiprocess: " + json.dumps(dict(
        card=card, processes=mh.N_PROC, gp=mh.GP, backend="gloo (through the host, one card)",
        pad_n=r0["gp"]["pad_n"],
        shard_vs_one_process={k: r0["gp"][k]["vs_one_process"]
                              for k in ("op_precise", "op_fast", "q_precise", "q_fast")},
        vjp_vs_one_process={k: r0["gp"][k]["vjp_vs_one_process"]
                            for k in ("op_precise", "op_fast")},
        q_vs_unsharded={k: r0["gp"][k]["vs_unsharded"] for k in ("q_precise", "q_fast")},
        loss=r0["gp"]["loss"], trainer={k: r0["trainer"][k] for k in (
            "removed", "losses", "one_process", "loss_rel", "param_diff", "wall_s",
            "one_process_wall_s")},
        dp_agent={k: r0["dp_agent"][k] for k in (
            "losses", "single", "loss_rel", "param_diff", "fit_s", "single_fit_s")},
        validate=r0["validate"], partition=r0["partition"]["errors"],
        timing={k: r0["timing"][k] for k in r0["timing"]},
        launches=counts, seconds=time.perf_counter() - t0)))
    return counts


# phase 16's step hold: the kernels' fwd+bwd step against K1's plain
# versions, of max|g|.  Precise: f32 sums in another order (REL_TOL).  bf16
# storage: y and the gradient each round to bf16, and a y that rounds the
# other way moves its cotangent by one bf16 ulp (2^-8 relative) through the
# backward's sums
TOOLS_STEP_TOL = {True: REL_TOL, False: 1e-2}
TOOLS_STEP_N = 18432      # the step hold's build: 72 blocks of 256 rows


def tools_step_hold(device, n=TOOLS_STEP_N):
    """bench_spmm's fwd+bwd step (BandSpmm: K1 forward, K1 with the scales
    swapped backward) in both arms against the same step by K1's plain
    versions (bench_spmm.plain_fwd_bwd) on bench.py's workload at n nodes
    and 4n edges: the gradient within TOOLS_STEP_TOL of max|g|.  Returns
    the errors by counter (of max|g|)."""
    from mdcommunity_tpu_torch import bench_spmm

    errs = {}
    for precise in (False, True):
        w = bench_spmm.workload(n, 4 * n, precise=precise, device=device)
        args = (w["dbg"], w["row"], w["col"], w["h"], precise)
        got, ref = bench_spmm.fwd_bwd(*args).float(), bench_spmm.plain_fwd_bwd(*args).float()
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item() / scale
        log(f"tools: bench_spmm step at {w['dbg'].pad_n} rows, precise={precise}: kernel vs "
            f"plain {err:.3e} of max|g| {scale:.3e}")
        if not err <= TOOLS_STEP_TOL[precise]:
            raise AssertionError(f"bench_spmm's step differs from K1's plain versions: {err}")
        for name in (("band_spmm", "band_spmm_bwd") if precise else
                     ("band_spmm_bf16_act", "band_spmm_bf16_bwd")):
            errs[name] = err * scale
    return errs


def tools_phase(device, ring, small=False):
    """Phase 16: the port's measurement entry points through their mains,
    every launch count set to 0 just before the four and read just after:
    bench_spmm (bench.py's workload) in its bf16 and precise arms on the
    probes' ring build `ring` (each arm's edges/s and its sol share, which
    must lie in (0, 1]), its step first held against K1's plain versions
    (tools_step_hold); scaling_bench at its defaults (the band engine at
    gp = 2 and 4 bit-equal to gp = 1, the edge partition within 1e-6 of
    max: scaling_bench raises otherwise); bench_cascade_host for 20
    batches; bf16_ab_train for 20 iterations (validations at 0 and 10).
    small: the CPU rehearsal's sizes.  Returns (the counts, the step
    hold's errors, the four JSON lines)."""
    from mdcommunity_tpu_torch import (
        bench_cascade_host,
        bench_spmm,
        bf16_ab_train,
        scaling_bench,
    )

    import torch

    t0 = time.perf_counter()
    errs = tools_step_hold(device, 2048 if small else TOOLS_STEP_N)
    cpu = ["--cpu"] if small else []
    n = ring.n
    runs = [
        ("bench_spmm", lambda: bench_spmm.main(cpu + ["--n", str(n), "--edges", str(4 * n)],
                                               ring=ring)),
        ("bench_spmm_precise", lambda: bench_spmm.main(
            cpu + ["--precise", "--n", str(n), "--edges", str(4 * n)], ring=ring)),
        ("scaling_bench", lambda: scaling_bench.main(
            cpu + (["--nodes", "4096", "--edges", "16384"] if small else []))),
        ("bench_cascade_host", lambda: bench_cascade_host.main(
            ["--max-batches", "20"] + (["--n", "4096", "--batch", "16"] if small else []))),
        ("bf16_ab_train", lambda: bf16_ab_train.main(
            cpu + ["--out", os.path.join(OUT, "bf16_ab")]
            + (["--smoke", "--iters", "4", "--save-frequency", "2"] if small
               else ["--iters", "20", "--save-frequency", "10"]))),
    ]
    reset_all_launches()
    lines = {}
    for name, run in runs:
        t1 = time.perf_counter()
        lines[name] = run()
        log(f"tool {name}: {time.perf_counter() - t1:.1f} s")
    counts = all_launches()
    for name in ("bench_spmm", "bench_spmm_precise"):
        sol = lines[name]["sol"]["sol_fraction"]
        if not small and not 0.0 < sol <= 1.0:
            raise AssertionError(f"{name}: sol share {sol} outside (0, 1]: the timing is wrong")
    if lines["bench_cascade_host"]["batches"] != 20:
        raise AssertionError("bench_cascade_host did not run its 20 batches")
    ab = lines["bf16_ab_train"]
    if not (len(ab["f32"]) == len(ab["bf16"]) == 2
            and all(math.isfinite(v) for v in ab["f32"] + ab["bf16"])):
        raise AssertionError(f"bf16_ab_train's curves: {ab}")
    if device != "cpu":
        for name in ("band_spmm_bf16_act", "band_spmm_bf16_bwd", "band_spmm", "band_spmm_bwd",
                     "band_halo_bf16", "band_halo_bf16_bwd"):
            if counts.get(name, 0) <= 0:
                raise AssertionError(f"kernel {name} was not launched by the tools")
        torch.cuda.empty_cache()
    log(f"tools phase: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    return counts, errs, lines


# ---------------------------------------------------------------- the cascade

CASCADE_SIZES = ((1 << 16, False), (1 << 20, False), (1 << 20, True))  # (n, shuffled)
CASCADE_BATCHES = 30
CASCADE_K = 1048
CASCADE_REL = 1e-12      # score and curve: the same f64 terms, summed in one order


def cascade_state(env):
    """What the loops read of an env: covered, sever masks, rank, terminal,
    t (alive_nodes is compared separately)."""
    return (env.covered.tobytes(), [s.tobytes() for s in env.sever], env.rank,
            env.terminal, env.t)


def check_cascade_kernels(device, env, label, timed=True):
    """Each csrc/cascade.cu kernel against its plain version on env's edges
    (the native engine's order) under a seeded state (10% of the nodes
    covered, 5% of each layer's edges severed, some actions out of range):
    alive, counts, labels, touched, severs, rank and masks exactly.  With
    timed, each kernel's median ms on the card (utils/timing.cuda_ms) beside
    its plain version's and its bound (bytes at PEAK_BYTES_S: u, v and the
    edge masks once, n-sized arrays once).  Returns the times."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.ops import cascade_kernels as ck

    n = env.n
    rng = np.random.default_rng(7)
    u = [torch.from_numpy(e[:, 0].astype(np.int32)).to(device) for e in env.edges]
    v = [torch.from_numpy(e[:, 1].astype(np.int32)).to(device) for e in env.edges]
    m = [len(e) for e in env.edges]
    sever = [torch.from_numpy(rng.random(k) < 0.05).to(device) for k in m]
    acts = torch.from_numpy(np.concatenate([rng.choice(n, n // 10, replace=False),
                                            [-1, n, n + 3]])).to(device)

    def fresh():
        return dict(covered=torch.zeros(n, dtype=torch.bool, device=device),
                    alive=[torch.empty(k, dtype=torch.bool, device=device) for k in m],
                    sever=[s.clone() for s in sever],
                    label=[torch.empty(n, dtype=torch.int32, device=device) for _ in m],
                    touched=[torch.empty(n, dtype=torch.bool, device=device) for _ in m],
                    ids=torch.zeros(m[1], dtype=torch.int32, device=device),
                    ctr=torch.zeros(4, dtype=torch.int64, device=device))

    def run(st, kern):
        f = {name: getattr(ck, name if kern else name + "_plain") for name in ck.NAMES}
        f["cover"](st["covered"], acts)
        for layer in (0, 1):
            f["live_edges"](u[layer], v[layer], st["sever"][layer], st["covered"],
                            st["alive"][layer], st["ctr"][layer:layer + 1])
            f["components"](u[layer], v[layer], st["alive"][layer], st["label"][layer],
                            st["touched"][layer])
        f["sever_test"](u[1], v[1], st["alive"][1], st["sever"][1], st["label"][0],
                        st["touched"][0], st["ids"], st["ctr"][2:3])
        f["rank"](st["label"][0], st["covered"], torch.empty(n, dtype=torch.int32,
                                                             device=device), st["ctr"][3:4])
        st["mask"] = torch.empty(n, dtype=torch.bool, device=device)
        f["alive_nodes"](u[1], v[1], st["alive"][1], st["mask"])
        st["ids"] = torch.sort(st["ids"][: int(st["ctr"][2])]).values
        return st

    got, want = run(fresh(), True), run(fresh(), False)
    for key in ("covered", "alive", "sever", "label", "touched", "ids", "ctr", "mask"):
        a, b = got[key], want[key]
        for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
            if not torch.equal(x, y):
                raise AssertionError(f"cascade kernels, {label}: {key} differs from the "
                                     "plain version")
    log(f"cascade kernels, {label}: equal to their plain versions (live "
        f"{got['ctr'][:2].tolist()}, severed {int(got['ctr'][2])}, rank {int(got['ctr'][3])})")
    if not timed:
        return {}
    st = got
    cnt = torch.zeros(1, dtype=torch.int64, device=device)
    scratch = torch.empty(n, dtype=torch.int32, device=device)
    ids = torch.empty(m[0], dtype=torch.int32, device=device)
    mask = torch.empty(n, dtype=torch.bool, device=device)
    cov_acts = acts[:CASCADE_K]
    # layer 0 against its own labels severs nothing: the common case, and
    # repeatable
    calls = {
        "cover": (lambda f: f(st["covered"], cov_acts), 9 * len(cov_acts)),
        "live_edges": (lambda f: f(u[0], v[0], st["sever"][0], st["covered"],
                                   st["alive"][0], cnt), 10 * m[0] + n),
        "components": (lambda f: f(u[0], v[0], st["alive"][0], st["label"][0],
                                   st["touched"][0]), 9 * m[0] + 5 * n),
        "sever_test": (lambda f: f(u[0], v[0], st["alive"][0], st["sever"][0],
                                   st["label"][0], st["touched"][0], ids, cnt), 9 * m[0] + 5 * n),
        "rank": (lambda f: f(st["label"][0], st["covered"], scratch, cnt), 5 * n),
        "alive_nodes": (lambda f: f(u[0], v[0], st["alive"][0], mask), 9 * m[0] + n),
    }
    out = {}
    for name, (call, nbytes) in calls.items():
        kern, plain = getattr(ck, name), getattr(ck, name + "_plain")
        out["cc_" + name] = dict(ms=time_ms(lambda: call(kern)),
                                 plain_ms=time_ms(lambda: call(plain)),
                                 bound_ms=1e3 * nbytes / PEAK_BYTES_S, bytes=nbytes)
    log(f"cascade kernel times, {label} (ms, median of 20; bound = bytes at 3.35 TB/s): "
        + json.dumps({k: {kk: float(f"{vv:.4g}") for kk, vv in r.items()}
                      for k, r in out.items()}))
    return out


def cascade_phase(device, small=False):
    """The banded loops' cascade on the card (env/device_cascade.py): at
    each of CASCADE_SIZES (synth_duplex_edges, degree 6; angular ids or
    shuffled) each kernel against its plain version (check_cascade_kernels;
    timed at 2^20 angular), then CASCADE_BATCHES batches of CASCADE_K
    hub-first removals (with out-of-range entries and repeats) through two
    native envs, one moved to the card with to(): after each batch the
    covered set, sever masks, rank, terminal, t and the batch's new severs
    (as sets) equal, alive_nodes every tenth batch, score and curve within
    CASCADE_REL; each engine's ms a batch.  small: the CPU rehearsal's sizes
    (the device engine on the plain versions).  Returns (kernel times, per
    size the engines' median ms a batch)."""
    import numpy as np
    import torch

    from mdcommunity_tpu_torch.env.host_env import make_host_env
    from mdcommunity_tpu_torch.large_graph_demo import synth_duplex_edges
    from mdcommunity_tpu_torch.ops import cascade_kernels as ck

    t0 = time.perf_counter()
    ck.reset_launches()
    times, rows = {}, {}
    sizes = ((2048, False), (4096, True)) if small else CASCADE_SIZES
    k = 16 if small else CASCADE_K
    for n, shuffled in sizes:
        label = f"{n} {'shuffled' if shuffled else 'angular'}"
        e0, e1 = synth_duplex_edges(n, 6, np.random.default_rng(0), shuffle=shuffled)
        ref = make_host_env(n, e0, e1, engine="native")
        timed = not small and n == 1 << 20 and not shuffled
        times.update(check_cascade_kernels(device, ref, label, timed=timed))
        dev = make_host_env(n, e0, e1, engine="native")
        if device == "cpu":
            dev.engage("cpu")
        else:
            dev.to(device)
        deg = np.bincount(np.concatenate([e0.ravel(), e1.ravel()]), minlength=n)
        order = np.argsort(-deg, kind="stable")
        ms = {"native": [], "device": []}
        for b in range(CASCADE_BATCHES):
            acts = order[b * k:(b + 1) * k]
            if b % 3 == 1:  # covered repeats and entries out of range
                acts = np.concatenate([acts, order[:5], [-1, n]])
            out = {}
            for name, env in (("native", ref), ("device", dev)):
                t1 = time.perf_counter()
                out[name] = env.step_many(acts)
                ms[name].append(1e3 * (time.perf_counter() - t1))
            r, d = out["native"], out["device"]
            same = (r[0] == d[0] and r[2] == d[2]
                    and all(np.array_equal(np.unique(x, axis=0), np.unique(y, axis=0))
                            for x, y in zip(r[1], d[1]))
                    and cascade_state(ref) == cascade_state(dev)
                    and abs(ref.score - dev.score) <= CASCADE_REL * abs(ref.score))
            if same and b % 10 == 9:
                same = all(np.array_equal(ref.alive_nodes(layer), dev.alive_nodes(layer))
                           for layer in (0, 1))
                rc, dc = np.asarray(ref.curve), np.asarray(dev.curve)
                same = same and len(rc) == len(dc) and bool(
                    np.all(np.abs(rc - dc) <= CASCADE_REL * np.abs(rc)))
            if not same:
                raise AssertionError(f"device cascade, {label}: batch {b} differs from the "
                                     "native engine")
            if ref.terminal:
                break
        st = dev.cascade_stats
        if device != "cpu" and st["on_device"] != 1:
            raise AssertionError("the moved env did not run its cascade on the card")
        rows[label] = {name: float(np.median(v)) for name, v in ms.items()}
        rows[label].update(batches=b + 1, rank=dev.rank, last_stats=st)
        log(f"device cascade, {label}: {b + 1} batches equal to the native engine; ms a "
            f"batch (median) native {rows[label]['native']:.3f}, device "
            f"{rows[label]['device']:.3f}; last cascade {json.dumps(st)}")
        del ref, dev
    if device != "cpu":
        if any(c <= 0 for c in ck.launches.values()):
            raise AssertionError(f"a cascade kernel was not launched: {ck.launches}")
        torch.cuda.empty_cache()
    log(f"cascade phase: {time.perf_counter() - t0:.1f} s, launches "
        + json.dumps(ck.launches))
    return times, rows


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
        check_edges("cpu")
        check_split("cpu")
        check_backward("cpu", 2048)
        check_bf16_backward("cpu", synth_banded(2048, True, 0, "cpu"), "rehearsal")
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
            bf16_fit_phase("cpu", small, edges, 16, gp)
        check_slice6_kernels("cpu", 2048)
        time_slice6("cpu", synth_banded(2048, True, 0, "cpu"),
                    synth_banded(2048, True, 0, "cpu", nibble=True),
                    synth_banded(2048, False, 0, "cpu", reorder=False, nibble=True), "rehearsal")
        # the untimed holds at the 2^20 rows' build options
        for hold in (time_kernels, time_bf16_kernels, time_epi_kernels, time_diag_kernels,
                     time_stream):
            hold("cpu", small, "rehearsal", timed=False)
        ring = probe_phase("cpu", small=True)[1]
        import dataclasses

        from mdcommunity_tpu_torch.utils.config import Config

        dqn_phase("cpu", dataclasses.replace(Config().smoke, save_frequency=5,
                                             update_time=5), iters=11, more=2)
        variant_phase("cpu", 2048, 0.01, lockstep=5,
                      small=dict(sizes=(32, 48), n_graphs=2, n_valid=8), big=small)
        variant_train_phase("cpu", small, edges, 16, n=2048, iters=11, more=2, gp=2,
                            cfg=dataclasses.replace(Config().smoke, save_frequency=5,
                                                    update_time=5))
        baselines_phase("cpu", *synth_banded(2048, True, 0, "cpu", with_edges=True),
                        2048, edges, small=True)
        multiprocess_phase("cpu", small=True)
        tools_phase("cpu", ring, small=True)
        cascade_phase("cpu", small=True)
        log("rehearsal done")
        return 0
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: chip_smoke.py needs one GPU")
    device = "cuda"
    t_start = time.perf_counter()

    def lap(phase):
        log(f"phase {phase}: done {time.perf_counter() - t_start:.1f} s after the start")

    log(gpu_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    # the variants' Louvain runs on the host while nvcc builds the kernels
    structures = threading.Thread(target=variant_structures, args=(18222,))
    structures.start()
    build_all()
    structures.join()
    lap("build")
    errs = check_kernels(device, 1 << 16)
    errs.update(check_bf16_kernels(device, 1 << 16))
    for more in (check_edges(device), check_split(device)):
        errs.update({k: max(v, errs.get(k, 0.0)) for k, v in more.items()})
    errs["band_spmm_bwd"] = check_backward(device, 1 << 16)
    for more in (check_halo_kernels(device, 1 << 16), check_slice6_kernels(device, 1 << 16)):
        errs.update({k: max(v, errs.get(k, 0.0)) for k, v in more.items()})
    log("f64 yardstick, worst of max|ref| (kernel on the rows held, f32 plain version, "
        "least share of rows held): "
        + json.dumps({k: [float(f"{x:.3e}") for x in v] for k, v in F64.items()}))

    lap("kernel checks")
    cascade_times, cascade_rows = cascade_phase(device)
    lap("cascade")
    main_graph = synth_banded(18222, True, 0, device)
    errs["band_spmm_bf16_bwd"] = check_bf16_backward(device, main_graph, "18,432 rows")
    times = time_kernels(device, main_graph, "18,432 rows")
    times.update(time_bf16_kernels(device, main_graph, "18,432 rows"))
    # the sharded engine refuses spill: the unshuffled build
    clean18 = synth_banded(18222, False, 0, device)
    times.update(time_halo_kernels(device, clean18, "18,432 rows"))
    times.update(time_slice6(device, main_graph, synth_banded(18222, True, 0, device, nibble=True),
                             synth_banded(18222, False, 0, device, nibble=True), "18,432 rows"))
    del main_graph, clean18
    lap("18,432-row timings")
    big, big_edges = synth_banded(1 << 20, False, 0, device, reorder=False,
                                  with_edges=True)
    lap("2^20-row build")
    # the same kernels against their plain versions at the 2^20 rows that
    # the training, bf16-fit, variant-training and probe paths give them
    # (the nibble modes, which only the probes run, at 2^16 and 18,432
    # rows); their times there are time_band_rows.py's (PERF.md §6)
    for more in (time_kernels(device, big, "2^20 rows", timed=False),
                 time_bf16_kernels(device, big, "2^20 rows", timed=False),
                 time_epi_kernels(device, big, "2^20 rows", timed=False),
                 time_diag_kernels(device, big, "2^20 rows", timed=False),
                 time_stream(device, big, "2^20 rows", timed=False)):
        errs.update({k: max(v["max_abs_err"], errs.get(k, 0.0)) for k, v in more.items()})
    torch.cuda.empty_cache()
    lap("2^20-row checks")
    blocked_errs, blocked_times = blocked_kernel_phases(device)
    lap("blocked kernels")

    counts, result = main_path(device, 18222, 0.001)
    for k in ("band_spmm", "band_sage", "cc_components"):
        if counts[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    log(f"main path AUDC {result['audc']:.6f} after {result['removed']} removals")
    lap("main path")
    fast_counts = fast_main_path(device, 18222, 0.001, result)[0]
    fwd_counts = fast_forward_phase(device, 18222)
    fast_counts = {k: fast_counts[k] + fwd_counts[k] for k in fast_counts}
    for name, _, _ in BF16_MODES:
        if fast_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the fast path")
    lap("fast paths")

    fit_err = check_fit(device, 18222)
    train_counts = trainer_phase(device, big, big_edges, 1048)
    fit_memory(device, big, 1048)
    lap("trainer")
    time_halo_kernels(device, big, "2^20 rows")
    halo_counts = sharded_forward_phase(device, big)
    shard_train_counts = sharded_trainer_phase(device, big, big_edges, 1048)
    halo_counts = {k: halo_counts[k] + shard_train_counts[k] for k in halo_counts}
    for name in ("band_halo", "band_halo_bf16", "band_halo_bf16_act", "band_halo_bwd"):
        if halo_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the sharded path")
    lap("sharded paths")
    bf16_fit_counts = bf16_fit_phase(device, big, big_edges, 1048)
    lap("bf16 fit")

    probe_counts, ring = probe_phase(device)
    for name, _, _ in SLICE6:
        if probe_counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the probes' path")

    lap("probes")
    small_graph_phase(device)
    lap("small-graph phase")
    bd, net, blocked_counts = blocked_phase(device, 18222, 18, BLOCKED_STEPS)
    grad_counts, grad_err = blocked_gradient_phase(bd, net)
    blocked_errs["sddmm_block"] = max(blocked_errs["sddmm_block"], grad_err)
    for name, c in (("spmm_block", blocked_counts), ("spmm_block_bwd", grad_counts),
                    ("sddmm_block", grad_counts)):
        if c[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on its path")
    lap("blocked path")
    dqn = dqn_phase(device)[0]
    lap("dqn trainer")
    variant_counts, variants, comm = variant_phase(device, big=big)
    lap("variants")
    vt_counts, vt = variant_train_phase(device, big, big_edges, 1048)
    del big
    torch.cuda.empty_cache()
    lap("variant training")
    tools = baselines_phase(device, *synth_banded(18222, True, 0, device, with_edges=True),
                            1 << 20, big_edges)
    del big_edges
    torch.cuda.empty_cache()
    lap("baselines and tools")
    mp_counts = multiprocess_phase(device)
    lap("multiprocess")
    tool_counts, tool_errs, tool_lines = tools_phase(device, ring)
    del ring
    for k, v in tool_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    lap("measurement tools")

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
    for name, mode in (
        ("band_spmm_bf16_bwd", "precise=False, f32 storage, the VJP (:811-829) with row "
                               "and col swapped: the bf16 fit's backward"),
        ("band_halo_bf16_bwd", "halo=True (:274-278), precise=False, f32 storage, the VJP "
                               "with row and col swapped (band_partition.py:312-327): the "
                               "sharded bf16 fit's backward"),
    ):
        t = dict(times[name])
        t["max_abs_err"] = max(errs[name], t["max_abs_err"])
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/band.cu",
            replaces="mdcommunity_tpu/ops/band_pallas.py:259", mode=mode,
            launches=bf16_fit_counts[name], **t))
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
    kernels.append(dict(
        name="hca_comm_adj", route="cuda", source="mdcommunity_tpu_torch/csrc/hca.cu",
        replaces="mdcommunity_tpu/ops/band_pallas.py:259 as HCA's community pass (JAX "
                 "hca_banded.py:141-146, the band operator on the one-hot membership)",
        mode=f"the binarised live community graph from the stored edges, c_pad = "
             f"{comm['c_pad']}; at 2^20 rows, c_pad = 4,096: its numbers under \"2^20\"",
        launches=variant_counts["hca"]["hca_comm_adj"],
        **{k: comm[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library_device_ms", "2^20")}))
    for row in kernels:
        # phase 15: K3 and its backward in each of the two processes
        multi = {k: c.get(row["name"], 0) for k, c in mp_counts.items()}
        if any(multi.values()):
            row["launches_multiprocess"] = multi
        # phase 16: the measurement entry points (bench_spmm, scaling_bench)
        if tool_counts.get(row["name"]):
            row["launches_tools"] = tool_counts[row["name"]]
        if row["name"] in ("band_spmm", "band_sage"):
            row["launches_variants"] = {v: c[row["name"]] for v, c in variant_counts.items()}
        # slice D2's paths: the degree-cost and CE banded loops, degree cost
        # at GP shards, and live_scales' degree pass (K1 at D = 1)
        train = {p: c[row["name"]] for p, c in vt_counts.items() if c.get(row["name"])}
        if train:
            row["launches_variant_training"] = train
    log(f"fit gradient vs CPU f64: worst leaf error {fit_err:.3e} of its max |grad|")
    log("dqn trainer: " + json.dumps(dqn))
    log("variant training: " + json.dumps(
        {v: {k: r[k] for k in ("fit_iters_per_s", "vcs", "peak_mem_gib", "wall_s",
                               "train_step_loss_rel", "train_step_worst_leaf", "rollout")}
         for v, r in vt.items() if v in ("ce", "hca")}, default=str))
    log("baselines and tools: " + json.dumps(tools))
    for name, line in tool_lines.items():
        log(f"{name}: " + json.dumps(line))
    for name, t in cascade_times.items():
        kernels.append(dict(
            name=name, route="cuda", source="mdcommunity_tpu_torch/csrc/cascade.cu",
            replaces="none (the JAX package's cascade is host C++, native/src/mdc_native.cpp)",
            mode="2^20 nodes, angular ids", launches=counts.get(name, 0), **t))
    log("device cascade against the native engine: " + json.dumps(
        {k: {kk: vv for kk, vv in r.items() if kk != "last_stats"}
         for k, r in cascade_rows.items()}))
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
