"""SpMM forward+backward edges/s of the band operator on one card: the
port's counterpart of bench.py (BASELINE.json's north-star metric).

Workload (bench.py:149-183, draw for draw from one
np.random.default_rng(seed)): a 2^20-node layer of circular power-law
offsets (graphs/synth.ring_powerlaw_edges, 2^22 edges symmetrised to 2^23),
its int8 band build (S = 256, B = 128), a 10% covered mask with the "sum"
scales, and h standard normal [pad_n, 64] stored in bf16 (f32 with
--precise).  A timed step is

    h <- h + d/dh[1e-6 * sum(f32(BandSpmm(h))^2)] / (1 + i)

through ops/dense_band.BandSpmm: kernel K1's bf16 mode
(csrc/band.cu::mdc_band_spmm_bf16) forward and, in BandSpmm.backward at
precise=False, backward (--precise: K1's precise mode both ways).  The
step's time is the slope of a chain of K = 8 and K = 40 steps (CUDA
events, utils/timing.cuda_ms; any per-chain constant cancels), beside the
device time of one step (utils/timing.device_ms).  The edges/s divide the
directed edges by the slope.  vs_baseline stays against bench.py's 6.0e8
edges/s, the reference's V100 estimate.  `sol` is the least time of a step
on this card over the slope: the bytes of two band passes
(utils/timing.band_pass_bytes) and the step's five elementwise streams at
3.35 TB/s, or the band's multiply-adds at 989 (bf16) or 67 (FP32) TFLOP/s.

On the CPU (--cpu) it runs the steps with the plain versions and times
nothing.  Prints one JSON line.

    python -m mdcommunity_tpu_torch.bench_spmm [--precise] [--density-sweep] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mdcommunity_tpu_torch.graphs.synth import ring_powerlaw_edges
from mdcommunity_tpu_torch.ops.band_kernels import spmm_band_plain
from mdcommunity_tpu_torch.ops.dense_band import (
    BandSpmm,
    band_rows,
    build_dense_band,
    live_scales,
    mirror_sub,
)
from mdcommunity_tpu_torch.ops.spmm_csr import spmm_sorted
from mdcommunity_tpu_torch.utils.device import resolve_device
from mdcommunity_tpu_torch.utils.timing import (
    PEAK_BYTES_S,
    band_pass_bytes,
    cuda_ms,
    device_ms,
    gpu_line,
)

METRIC = "spmm_fwdbwd_edges_per_s_per_chip"
BASELINE_EDGES_PER_S = 6.0e8  # bench.py: the reference's V100 estimate
PEAK_BF16_S = 989e12          # H100 SXM bf16 tensor cores, dense
PEAK_F32_S = 67e12            # H100 SXM FP32 outside the tensor cores
KS = (8, 40)                  # chain lengths of the slope
GLUE_STREAMS = 5              # cotangent: read y, write g; update: read h, dh, write h


def workload(n: int = 1 << 20, e: int = 1 << 22, seed: int = 0, D: int = 64,
             precise: bool = False, S: int = 256, B: int = 128, device=None, dbg=None):
    """bench.py's draws: edges, the int8 band build (dbg, when given, must
    be that build: graphs/synth.ring_band_graph(n, e, S, B, seed) is), the
    covered mask and h, from one default_rng(seed) in bench.py's order.
    Returns a dict: dbg, row, col (the sum scales), h (bf16, or f32 with
    precise), src and dst (the directed edges before symmetrising) and the
    count of directed edges."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src, dst = ring_powerlaw_edges(n, e, rng)
    if dbg is None:
        dbg = build_dense_band(np.concatenate([src, dst]), np.concatenate([dst, src]), n,
                               S=S, B=B, device=device)
    elif (dbg.n, dbg.S, dbg.B, dbg.nibble) != (n, S, B, False):
        raise ValueError("dbg is not this workload's int8 build")
    covered = torch.from_numpy(rng.random(dbg.pad_n) < 0.1).to(dbg.device)
    row, col = live_scales(dbg, covered, "sum")
    h = torch.from_numpy(rng.standard_normal((dbg.pad_n, D)).astype(np.float32))
    h = h.to(dbg.device).to(torch.float32 if precise else torch.bfloat16)
    return dict(dbg=dbg, row=row, col=col, h=h, src=src, dst=dst, directed_edges=2 * e)


def fwd_bwd(dbg, row, col, h, precise: bool) -> torch.Tensor:
    """d/dh of 1e-6 * sum(f32(BandSpmm(h))^2), in h's dtype: K1 forward and
    K1 with the scales swapped backward (their plain versions on the CPU)."""
    x = h.detach().requires_grad_(True)
    y = BandSpmm.apply(dbg, row, col, x, precise)
    (g,) = torch.autograd.grad(torch.sum(torch.square(y.float())) * 1e-6, x)
    return g


def grad_step(dbg, row, col, h, i: int, precise: bool) -> torch.Tensor:
    """One timed step, bench.py's body: h + fwd_bwd(h) / (1 + i)."""
    return h + fwd_bwd(dbg, row, col, h, precise) / (1.0 + i)


def _plain_operator(dbg, row, col, h, precise):
    """spmm_dense_band with K1's plain version in place of the kernel, on
    any device: the band and mirror part, then the spill in f32."""
    out = spmm_band_plain(dbg, row, col, h, mirror_sub(dbg, col, h, precise), precise)
    if dbg.spill.nnz:
        sp = spmm_sorted(dbg.spill, dbg.w_spill, h.to(row.dtype) * col[:, None])
        out = (out.to(sp.dtype) + sp * row[:, None]).to(h.dtype)
    return out


def plain_fwd_bwd(dbg, row, col, h, precise: bool) -> torch.Tensor:
    """fwd_bwd by K1's plain version both ways, the gradient written out:
    the cotangent 2e-6 * f32(y) in h's dtype through the operator with the
    scales swapped.  chip_smoke.py holds the kernels' step to it."""
    y = _plain_operator(dbg, row, col, h, precise)
    return _plain_operator(dbg, col, row, (2e-6 * y.float()).to(h.dtype), precise)


def chain(w, K: int) -> torch.Tensor:
    """K steps from w's h (a new tensor; w's h is not changed)."""
    x = w["h"]
    for i in range(K):
        x = grad_step(w["dbg"], w["row"], w["col"], x, i, w["precise"])
    return x


def step_bound(dbg, D: int, precise: bool) -> dict:
    """The least time of one step on the card, from this build's numbers:
    two band passes' bytes (band_pass_bytes at h's storage width) and the
    glue's GLUE_STREAMS h-sized streams at PEAK_BYTES_S; the band's
    multiply-adds, one per band nonzero and column a pass, at the bf16 or
    FP32 peak."""
    store = 4 if precise else 2
    nbytes = 2 * band_pass_bytes(dbg, D, store) + GLUE_STREAMS * dbg.pad_n * D * store
    nnz = int((band_rows(dbg) != 0).sum().item())
    ops = 2 * 2 * nnz * D
    t_b = nbytes / PEAK_BYTES_S
    t_o = ops / (PEAK_F32_S if precise else PEAK_BF16_S)
    return dict(bytes_step=nbytes, ops_step=ops, bound_ms=1e3 * max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")


def measure(w, reps: int = 5, on_card: bool = True) -> dict:
    """edges/s of the workload `w` (workload() plus precise): the slope of
    the chain's median time over KS, the device time of one step, and the
    step's bound beside both.  Off the card the chains run once, untimed."""
    dbg, D = w["dbg"], w["h"].shape[1]
    bound = step_bound(dbg, D, w["precise"])
    out = dict(directed_edges=w["directed_edges"], pad_n=dbg.pad_n, C=dbg.C,
               band_density=w["directed_edges"] / (dbg.pad_n * dbg.W2), **bound)
    if not on_card:
        for K in KS:
            if not torch.isfinite(chain(w, K).float()).all():
                raise AssertionError("the chain gave non-finite values")
        return dict(out, edges_per_s=None, t_step_ms=None, device_ms_step=None,
                    sol_fraction=None, sol_fraction_device=None)
    med = {K: cuda_ms(lambda K=K: chain(w, K), reps=reps, warm=1) for K in KS}
    t_step = (med[KS[1]] - med[KS[0]]) / (KS[1] - KS[0])
    if not t_step > 0:
        raise RuntimeError(f"non-positive chain slope {t_step} ms: chain medians {med}")
    dev = device_ms(lambda: grad_step(dbg, w["row"], w["col"], w["h"], 0, w["precise"]))
    return dict(out, edges_per_s=w["directed_edges"] / (t_step / 1e3), t_step_ms=t_step,
                chain_ms={str(k): v for k, v in med.items()}, device_ms_step=dev,
                achieved_gb_s=bound["bytes_step"] / t_step / 1e6,
                sol_fraction=bound["bound_ms"] / t_step,
                sol_fraction_device=bound["bound_ms"] / dev)


def main(argv=None, ring=None):
    """The JSON line (also returned).  ring: the headline point's int8
    build, graphs/synth.ring_band_graph(n, edges), when the
    caller has it (chip_smoke.py reuses its probes')."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--precise", action="store_true",
                    help="K1's precise mode both ways, h in f32")
    ap.add_argument("--density-sweep", action="store_true",
                    help="also 2^21 and 2^23 edges (bench.py's sweep)")
    ap.add_argument("--cpu", action="store_true", help="the plain versions, untimed")
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--edges", type=int, default=1 << 22, help="before symmetrising")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    on_card = device.type == "cuda"

    def point(e, dbg=None):
        w = workload(args.n, e, precise=args.precise, device=device, dbg=dbg)
        w["precise"] = args.precise
        return measure(w, on_card=on_card)

    head = point(args.edges, ring)
    value = head["edges_per_s"]
    out = dict(metric=METRIC, value=value, unit="edges/s",
               vs_baseline=None if value is None else value / BASELINE_EDGES_PER_S,
               mode="precise" if args.precise else "bf16", n=args.n, card=gpu_line(),
               device=str(device), sol=head)
    if args.density_sweep:
        keys = ("directed_edges", "band_density", "edges_per_s", "t_step_ms", "sol_fraction")
        sweep = [point(e) for e in (args.edges // 2, args.edges * 2)]
        out["density_sweep"] = [{k: r[k] for k in keys} for r in (sweep[0], head, sweep[1])]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
