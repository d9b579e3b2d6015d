"""Scaling of the two gp engines' fwd+bwd edges/s: the port's counterpart
of scripts/scaling_bench.py.

Both graph-parallel aggregation engines run a value-and-gradient of
sum(y²) at gp = 1, 2, 4 on the JAX script's workload (its draws from
np.random.default_rng(0): a locality-ordered ring of circular power-law
offsets, self-loops dropped, symmetrised; edge weights, h and a 10% cover;
2^17 nodes, 2^21 edges, D = 64 by default):

  band  the halo-exchange band engine, parallel/band_partition's
        ShardedBandSpmm (kernel K3 and, for the gradient, K3 with the
        scales swapped; the JAX script's default bf16 mode, f32 h) on the
        int8 build (S = 256, B = 128, mirror capacity 256, no spill);
  coo   the edge partition, parallel/partition.spmm_edge_partitioned (f32).

Each gp's edges/s is the directed edges over the best of 3 means of
`--iters` calls (host clock around work that ends in a synchronise), its
efficiency that over gp times gp = 1's.  The line also gives, per engine
and gp, the bytes that cross shard boundaries in a call (halos, the mirror
table's gather, the partials' all-reduce).  The band engine at gp = 2 and 4
must give gp = 1's output and gradient bit for bit (K3 gives K1's bits),
the edge partition within 1e-6 of max|·| (its partials add in another
order); it raises otherwise.

On one card every shard sits on that card, so the line says "cards": 1: it
measures the plumbing, not scaling.  Under parallel/mesh.init_distributed
(several processes, e.g. launched as multihost_smoke launches its
children) the gp axis spans the processes; a gp smaller than the process
count runs in each process alone.  --cpu runs the plain versions and times
nothing.  The JAX script's packed engine has no counterpart (the port's
kernels read the band build itself).  Prints one JSON line.

    python -m mdcommunity_tpu_torch.scaling_bench [--nodes 131072] [--edges 2097152] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.dense_band import build_dense_band, live_scales
from mdcommunity_tpu_torch.parallel.band_partition import (
    shard_band_graph,
    spmm_band_sharded_grad,
)
from mdcommunity_tpu_torch.parallel.mesh import (
    add_in_order,
    all_gather,
    gather_nodes,
    init_distributed,
    make_mesh,
    reduce_grads,
    split_nodes,
)
from mdcommunity_tpu_torch.parallel.partition import shard_edges, spmm_edge_partitioned
from mdcommunity_tpu_torch.utils.device import resolve_device
from mdcommunity_tpu_torch.utils.timing import gpu_line

GPS = (1, 2, 4)
COO_TOL = 1e-6   # of max|·|: the edge partition's partials add in shard order
S, B, MAX_MIRROR = 256, 128, 256


def workload(n: int, e: int, d: int, device, seed: int = 0) -> dict:
    """The JAX script's draws, in its order: e/2 ring edges, self-loops
    dropped and symmetrised; w [E], h [n, d] and the cover [n]; the band
    build (raises on spill, as the script asserts).  h and the cover are
    padded to the build's pad_n (zero rows, covered)."""
    rng = np.random.default_rng(seed)
    usrc = rng.integers(0, n, e // 2).astype(np.int64)
    off = (8.0 * (rng.pareto(2.5, e // 2) + 1.0)).astype(np.int64)
    off = np.minimum(off, n // 2 - 1) * rng.choice(np.array([-1, 1]), e // 2)
    udst = (usrc + off) % n
    keep = usrc != udst
    usrc, udst = usrc[keep], udst[keep]
    src, dst = np.concatenate([usrc, udst]), np.concatenate([udst, usrc])
    w = rng.random(len(src)).astype(np.float32)
    h = rng.standard_normal((n, d)).astype(np.float32)
    covered = rng.random(n) < 0.1
    dbg = build_dense_band(src, dst, n, S=S, B=B, max_mirror=MAX_MIRROR, device=device)
    if dbg.spill.nnz:
        raise ValueError("the workload's band build spills; the band engine needs none")
    pad = dbg.pad_n - n
    h = np.concatenate([h, np.zeros((pad, d), np.float32)])
    covered = np.concatenate([covered, np.ones(pad, bool)])
    t = torch.from_numpy
    return dict(n=n, dbg=dbg, src=t(src).to(device), dst=t(dst).to(device),
                w=t(w).to(device), h=t(h).to(device), covered=t(covered).to(device))


def band_step(mesh, sdbg, row_s, col_s, h):
    """sum(y²) of the sharded band operator and its gradient for h: (y,
    dh, loss), the pieces gathered to [pad_n, ·] (on the mesh's home)."""
    hs = [x.clone().requires_grad_() for x in split_nodes(mesh, h)]
    ys = spmm_band_sharded_grad(mesh, sdbg, row_s, col_s, hs, precise=False)
    loss = add_in_order([torch.sum(y * y).to(mesh.home) for y in ys])
    loss.backward()
    return gather_nodes(mesh, [y.detach() for y in ys]), gather_nodes(
        mesh, [x.grad for x in hs]), loss.detach()


def coo_step(mesh, edges, h, n_edges):
    """sum(y²) of the edge partition and its gradients for h and w: (y, dh,
    dw over the first n_edges edges, loss).  Across processes the
    replicated h's gradient is summed (reduce_grads); each process's edge
    slices get theirs through the all-reduce's backward, and dw's slices
    are gathered in shard order."""
    src, dst, w0 = edges
    hh = h.clone().requires_grad_()
    w = [x.clone().requires_grad_() for x in w0]
    y = spmm_edge_partitioned(mesh, src, dst, w, hh)[0]
    loss = torch.sum(y * y)
    # each process's loss is the whole: count it once across processes
    (loss * float(mesh.rank == 0)).backward()
    reduce_grads(mesh, [hh])
    dw = all_gather(mesh, [x.grad for x in w])[0][:n_edges]
    return y.detach(), hh.grad, dw, loss.detach()


def collective_bytes(engine: str, gp: int, dbg, d: int) -> int:
    """Bytes that cross shard boundaries in one fwd+bwd call: band, each
    pass's two B-row halos of h (f32) and col a shard and the mirror
    table's gather ((gp − 1) shards' slices to each); coo, each pass's
    all-reduce of the [pad_n, d] f32 partials (2 (gp − 1) copies in a
    ring).  0 at gp = 1."""
    if gp == 1:
        return 0
    if engine == "band":
        halos = gp * 2 * dbg.B * (d + 1) * 4
        mirror = (gp - 1) * dbg.n_blocks * dbg.C * d * 4
        return 2 * (halos + mirror)
    return 2 * 2 * (gp - 1) * dbg.pad_n * d * 4


def run(wl: dict, iters: int = 5, on_card: bool = True) -> dict:
    """Both engines at each gp of GPS on the workload `wl`: edges/s,
    efficiency and collective bytes (times only on the card), and the
    outputs against gp = 1's (band: bit-equal; coo: within COO_TOL of
    max), raising where they differ.  Returns the result dict and, under
    "outputs", each engine's (y, dh[, dw]) by gp."""
    import torch.distributed as dist

    dbg, device = wl["dbg"], wl["h"].device
    d = wl["h"].shape[1]
    world = dist.get_world_size() if dist.is_initialized() else 1
    e_real = int(wl["src"].shape[0])
    row, col = live_scales(dbg, wl["covered"], "sum")

    def sync():
        if on_card:
            torch.cuda.synchronize()
        if world > 1:
            dist.barrier()

    def timed(fn):
        fn()
        sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            sync()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    res, outputs = dict(), dict(band={}, coo={})
    for engine in ("band", "coo"):
        rows = []
        for gp in GPS:
            procs = world if gp % world == 0 else 1
            mesh = make_mesh(gp, device, processes=procs)
            if engine == "band":
                sdbg = shard_band_graph(mesh, dbg)
                row_s, col_s = split_nodes(mesh, row), split_nodes(mesh, col)

                def fn(mesh=mesh, sdbg=sdbg, row_s=row_s, col_s=col_s):
                    return band_step(mesh, sdbg, row_s, col_s, wl["h"])
            else:
                pad = -e_real % gp   # w = 0 edges pad the slices
                ext = [torch.cat([x, x.new_zeros(pad)]) for x in (wl["src"], wl["dst"],
                                                                  wl["w"])]
                edges = shard_edges(mesh, *ext)

                def fn(mesh=mesh, edges=edges):
                    return coo_step(mesh, edges, wl["h"], e_real)
            outputs[engine][gp] = tuple(x.cpu() for x in fn()[:-1])
            dt = timed(fn) if on_card else None
            rows.append(dict(gp=gp, processes=procs, seconds=dt,
                             edges_per_s=None if dt is None else e_real / dt,
                             collective_bytes=collective_bytes(engine, gp, dbg, d)))
        base = rows[0]["edges_per_s"]
        for r in rows:
            eps = r["edges_per_s"]
            r["efficiency"] = None if eps is None else eps / (base * r["gp"])
            r["throughput_retention_vs_1dev"] = None if eps is None else eps / base
        res[engine] = rows
    res["vs_gp1"] = _hold(outputs)
    res["outputs"] = outputs
    return res


def _hold(outputs) -> dict:
    """Each engine's outputs at every gp against gp = 1's: the band engine
    bit for bit, the edge partition within COO_TOL of max|·|.  Returns the
    worst difference over max by engine and gp; raises past the bound."""
    worst = {}
    for engine, tol in (("band", 0.0), ("coo", COO_TOL)):
        ref = outputs[engine][1]
        for gp, got in outputs[engine].items():
            if gp == 1:
                continue
            err = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                      for a, b in zip(got, ref))
            worst[f"{engine}_gp{gp}"] = err
            if not err <= tol:
                raise AssertionError(f"the {engine} engine at gp={gp} differs from gp=1 by "
                                     f"{err:.3e} of max (bound {tol})")
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nodes", type=int, default=1 << 17)
    ap.add_argument("--edges", type=int, default=1 << 21)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="the plain versions, untimed")
    args = ap.parse_args(argv)
    init_distributed()   # torchrun's variables, or one process
    import torch.distributed as dist

    device = resolve_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"
    wl = workload(args.nodes, args.edges, args.dim, device)
    res = run(wl, iters=args.iters, on_card=on_card)
    del res["outputs"]
    world = dist.get_world_size() if dist.is_initialized() else 1
    cards = min(world, torch.cuda.device_count()) if on_card else 0
    out = dict(metric="edge_partitioned_spmm_scaling", nodes=args.nodes,
               edges=int(wl["src"].shape[0]), dim=args.dim, processes=world, cards=cards,
               device=str(device), card=gpu_line(), band_mode="precise=False (bf16), f32 h",
               **res)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
