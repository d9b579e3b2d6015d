"""Nibble base storage against int8: the same bits, and the time of a
forward and a backward pass of the band operator.

The port's counterpart of the JAX package's scripts/bench_nibble.py.  A
nibble build (ops/dense_band.build_dense_band(nibble=True)) stores two window
columns a byte, so the band kernels read half the base bytes; it holds
values up to 7, so the workloads are deduplicated simple graphs
(graphs/synth.dedupe).

  1. Correctness at --n-check nodes (2^18; 2^20 ring edges of scale 24, as
     the JAX script): the operator's forward (ops/dense_band.
     spmm_dense_band, both precise modes) and its gradient (BandSpmm, whose
     backward is K1 with the scales swapped) on the nibble build must equal
     the int8 build's bit for bit, before and after a batch of severs that
     holds duplicates and both cells of one base byte, in the f32 mode and
     the bf16 mode with h stored in f32 and in bf16; and, on the spill-free
     scale-8 workload at the same size, the fused step (kernel K2, with
     either epilogue) and the gp-sharded operator (kernel K3, GP = 4 shards
     on the one device) in the three modes, and the sharded gradient.  A
     --n-check whose scale-8 build spills, or whose block count GP does not
     divide, raises ValueError: no check is skipped.
  2. Speed at --n nodes (2^20, 2^22 ring edges, S = 256, B = 128, D = 64):
     one forward and one backward operator pass (the backward with the
     scales swapped, on a cotangent), nibble against int8, in the f32 and
     the bf16 mode, CUDA events (median of --reps after warm-ups), beside
     each storage's bytes bound at the data sheet's 3.35 TB/s.

Prints one JSON line, with the card's name and power limit.  On the CPU
(--device cpu, small --n-check and --n) it runs the checks and times
nothing.

    python -m mdcommunity_tpu_torch.bench_nibble
    python -m mdcommunity_tpu_torch.bench_nibble --device cpu --n-check 4096 --n 4096
"""

from __future__ import annotations

import argparse
import json

import numpy as np

GP = 4   # shards of the sharded check, all on the one device

def sever_batch(dbg, rng, k: int = 64):
    """(src, dst, valid) of k in-band directed edges of dbg and their
    reverses, with each of the first 8 repeated, one padding entry and, where
    the band has one, the two cells (w, w + 1) of one base byte: the cases a
    nibble sever must get right."""
    import torch

    from mdcommunity_tpu_torch.ops.dense_band import band_rows

    band = band_rows(dbg).cpu().numpy()
    blk, r, c = np.nonzero(band)
    pick = rng.choice(len(blk), size=min(k, len(blk)), replace=False)
    S, B, pad_n = dbg.S, dbg.B, dbg.pad_n
    dst = blk[pick] * S + r[pick]
    src = (blk[pick] * S - B + c[pick]) % pad_n
    pairs = (c[:-1] % 2 == 0) & (c[1:] == c[:-1] + 1) & (blk[1:] == blk[:-1]) & (
        r[1:] == r[:-1])
    if pairs.any():   # both nibbles of one byte
        i = int(np.flatnonzero(pairs)[0])
        for j in (i, i + 1):
            dst = np.r_[dst, blk[j] * S + r[j]]
            src = np.r_[src, (blk[j] * S - B + c[j]) % pad_n]
    src = np.r_[src, src[:8], 0]
    dst = np.r_[dst, dst[:8], 0]
    valid = np.ones(len(src), bool)
    valid[-1] = False
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dbg.device)  # noqa: E731
    return (t(np.r_[src, dst]), t(np.r_[dst, src]), t(np.r_[valid, valid]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n-check", type=int, default=1 << 18)
    ap.add_argument("--n", type=int, default=1 << 20, help="nodes of the timed "
                    "workload (4n edges before deduplication)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from mdcommunity_tpu_torch.graphs.synth import band_operands, ring_band_graph
    from mdcommunity_tpu_torch.ops.band_kernels import sage_step
    from mdcommunity_tpu_torch.ops.dense_band import (
        mirror_sub, sever_edges, spmm_dense_band, spmm_dense_band_grad)
    from mdcommunity_tpu_torch.parallel.band_partition import (
        shard_band_graph, spmm_band_sharded, spmm_band_sharded_grad)
    from mdcommunity_tpu_torch.parallel.mesh import gather_nodes, make_mesh, split_nodes
    from mdcommunity_tpu_torch.utils.device import resolve_device
    from mdcommunity_tpu_torch.utils.timing import (
        PEAK_BYTES_S, band_pass_bytes, cuda_ms, gpu_line)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    D = 64
    out = dict(probe="bench_nibble", device=str(device), gpu=gpu_line(),
               n_check=args.n_check, n=args.n, D=D)

    # 1. correctness: the nibble build gives the int8 build's bits
    def graphs(n, seed, scale=8.0):
        """The int8 and the nibble build of one deduplicated workload."""
        return [ring_band_graph(n, 4 * n, seed=seed, simple=True, nibble=nib,
                                scale=scale, device=str(device))
                for nib in (False, True)]

    i8, nib = graphs(args.n_check, 1, 24.0)
    live, h = band_operands(i8, D, 2)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (i8.pad_n, D), dtype=np.float32)).to(device)

    checks = {}

    def same(name, pair):
        a, b = pair
        diff = (a.float() - b.float()).abs().max().item()
        if not torch.equal(a, b):
            raise AssertionError(f"nibble {name} differs from int8 by {diff}")
        checks[name] = diff

    def passes(dbg):
        x = h.clone().requires_grad_()
        (dh,) = torch.autograd.grad(spmm_dense_band_grad(dbg, live, live, x), x, g)
        return dict(forward=spmm_dense_band(dbg, live, live, h), backward=dh, **{
            f"forward_{m}": spmm_dense_band(dbg, live, live, h.to(dt), precise=False)
            for m, dt in (("bf16", torch.float32), ("bf16_act", torch.bfloat16))})

    for when in ("fresh", "after_severs"):
        if when == "after_severs":
            batch = sever_batch(i8, np.random.default_rng(4))
            for dbg in (i8, nib):
                sever_edges(dbg, *batch)
        ref, got = passes(i8), passes(nib)
        for name in ref:
            same(f"{name}_{when}", (ref[name], got[name]))
    del i8, nib
    # the fused step (K2, either epilogue) and the sharded operator (K3) and
    # its gradient on the scale-8 workload, whose build has no spill, over
    # GP shards of one device, in the three modes
    i8, nib = graphs(args.n_check, 0)
    if i8.spill.nnz or i8.n_blocks % GP:
        raise ValueError(f"--n-check {args.n_check}: the fused and sharded checks need a "
                         f"spill-free build of a multiple of {GP} blocks (spill "
                         f"{i8.spill.nnz}, {i8.n_blocks} blocks)")
    mesh = make_mesh(GP, device)
    live, h = band_operands(i8, D, 7)
    h = torch.nn.functional.normalize(h, dim=-1)
    wr = np.random.default_rng(8)
    aw, bw = (torch.from_numpy((wr.standard_normal((D, D)) / 8).astype(np.float32))
              .to(device) for _ in range(2))
    for precise, dt in ((True, torch.float32), (False, torch.float32),
                        (False, torch.bfloat16)):
        m = "f32" if precise else ("bf16" if dt == torch.float32 else "bf16_act")
        hh = h.to(dt)
        sub = [mirror_sub(dbg, live, hh, precise) for dbg in (i8, nib)]
        for epi in (True, False):
            same(f"sage_{m}{'' if epi else '_bf16epi'}", [
                sage_step(dbg, live, live, hh, s, aw, bw, precise, f32_epi=epi)
                for dbg, s in zip((i8, nib), sub)])
        parts = [split_nodes(mesh, x) for x in (live, live, hh)]
        same(f"sharded_{m}", [gather_nodes(mesh, spmm_band_sharded(
            mesh, shard_band_graph(mesh, dbg), *parts, precise=precise))
            for dbg in (i8, nib)])
    grads = []
    for dbg in (i8, nib):
        xs = [p.clone().requires_grad_() for p in split_nodes(mesh, h)]
        grads.append(gather_nodes(mesh, list(torch.autograd.grad(
            spmm_band_sharded_grad(mesh, shard_band_graph(mesh, dbg),
                                   split_nodes(mesh, live), split_nodes(mesh, live), xs),
            xs, split_nodes(mesh, h)))))
    same("sharded_backward", grads)
    out["bits_equal"] = checks
    del i8, nib

    # 2. speed: one forward and one backward operator pass at the workload
    speed = {}
    big = graphs(args.n, 0)
    live, h = band_operands(big[0], D, 5)
    g = band_operands(big[0], D, 6)[1]
    for precise in (True, False):
        row = {}
        for tag, dbg in zip(("int8", "nibble"), big):
            def fwd_bwd(dbg=dbg):
                spmm_dense_band(dbg, live, live, h, precise=precise)
                spmm_dense_band(dbg, live, live, g, precise=precise)

            nbytes = 2 * band_pass_bytes(dbg, D)
            row[tag] = dict(ms=cuda_ms(fwd_bwd, args.reps, args.warm) if on_card else None,
                            bound_ms=1e3 * nbytes / PEAK_BYTES_S,
                            base_mb=dbg.base.numel() / 1e6)
        if on_card:
            row["speedup"] = row["int8"]["ms"] / row["nibble"]["ms"]
        speed["f32" if precise else "bf16"] = row
    out["fwd_bwd"] = speed
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
