"""The card's practical memory rate beside the data sheet's, and the band
kernel's rate at the headline workload.

The port's counterpart of the JAX package's scripts/probe_hbm_roof.py,
scripts/probe_pallas_stream.py and scripts/probe_overlap.py.  It measures:

  * the copy ceiling y = x·c over f32 arrays of 256 MB and 1 GB (one read
    and one write an element; a PyTorch call, a yardstick and not a kernel
    of the port);
  * the stream probe (ops/probe_kernels.stream_sum, csrc/probe.cu: a sum of
    each group of G int8 blocks) over the JAX probe's three shapes, (4096,
    256, 512) with G = 8 and G = 32 and (512, 2048, 512) with G = 4, and over
    the band base of the headline workload; and once with the overlap
    probe's extra masked reductions;
  * kernel K1's full, nodot and noscale variants (ops/band_kernels.spmm_band
    diag=) on the headline workload, 2^20 nodes and 2^22 random ring edges
    (graphs/synth.ring_band_graph), S = 256, B = 128, D = 64.

Each is first held to its plain version (the stream sums exactly, the K1
variants to 1e-4 of max|ref|: f32 sums in another order).  Rates are
bytes over CUDA-event time (median of --reps after warm-ups), beside the
data sheet's 3.35 TB/s and the card's name and power limit.  Prints one
JSON line.  On the CPU (--device cpu, a small --n) it runs the checks at a
size scaled by n / 2^20 and times nothing.

    python -m mdcommunity_tpu_torch.probe_hbm_roof
    python -m mdcommunity_tpu_torch.probe_hbm_roof --device cpu --n 4096
"""

from __future__ import annotations

import argparse
import json

# the JAX probes' (nb, rows, width, G) and, with extra, probe_overlap.py's
STREAMS = ((4096, 256, 512, 8), (4096, 256, 512, 32), (512, 2048, 512, 4))
KERNEL_TOL = 1e-4   # K1 variants vs plain: f32 sums in another order


def main(argv=None, ring=None):
    """ring: the K1 workload's build, ring_band_graph(n, 4n), when the
    caller has it (chip_smoke.py builds it once for its probes)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1 << 20, help="nodes of the K1 workload "
                    "(4n edges); the stream shapes scale by n / 2^20")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from mdcommunity_tpu_torch.graphs.synth import band_operands, ring_band_graph
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import mirror_sub
    from mdcommunity_tpu_torch.ops.probe_kernels import stream_sum, stream_sum_plain
    from mdcommunity_tpu_torch.utils.device import resolve_device
    from mdcommunity_tpu_torch.utils.timing import (
        PEAK_BYTES_S, band_pass_bytes, cuda_ms, gpu_line)

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    frac = args.n / (1 << 20)

    def timed(fn, nbytes):
        if not on_card:
            return dict(ms=None, gb_s=None, datasheet_share=None)
        ms = cuda_ms(fn, args.reps, args.warm)
        return dict(ms=ms, gb_s=nbytes / ms / 1e6, datasheet_share=nbytes / ms / 1e-3
                    / PEAK_BYTES_S)

    out = dict(probe="hbm_roof", n=args.n, device=str(device), gpu=gpu_line(),
               datasheet_gb_s=PEAK_BYTES_S / 1e9)

    # 1. the copy ceiling (PyTorch's elementwise kernel; the yardstick)
    copies = {}
    for label, mb in (("256MB", 256), ("1GB", 1024)):
        if not on_card:
            copies[label] = dict(ms=None, gb_s=None, datasheet_share=None)
            continue
        x = torch.ones(mb * 2**18, dtype=torch.float32, device=device)
        y = torch.empty_like(x)
        copies[label] = timed(lambda: torch.mul(x, 1.0000001, out=y), 2 * x.numel() * 4)
        del x, y
    out["copy"] = copies

    # 2. the stream probe over the JAX shapes, the base's shape, and extra
    dbg = ring if ring is not None else ring_band_graph(args.n, 4 * args.n,
                                                        device=str(device))
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = [(nb, r, w, G, False) for nb, r, w, G in STREAMS]
    shapes += [(STREAMS[0][0], STREAMS[0][1], STREAMS[0][2], STREAMS[0][3], True)]
    streams = []
    for nb, rows, width, G, extra in shapes:
        nb = max(G, int(nb * frac) // G * G)
        x = torch.randint(0, 3, (nb, rows, width), generator=gen, device=device,
                          dtype=torch.int8)
        got = stream_sum(x, G, extra)
        err = (got - stream_sum_plain(x, G, extra)).abs().max().item()
        if err != 0:
            raise AssertionError(f"stream_sum {x.shape} G={G} extra={extra}: off by {err}")
        streams.append(dict(shape=[nb, rows, width], G=G, extra=extra, max_abs_err=err,
                            **timed(lambda: stream_sum(x, G, extra), x.numel())))
        del x
    base = dbg.base  # the band build's own base, read as the probe reads it
    nb = base.shape[0] // 8 * 8
    got = stream_sum(base[:nb], 8)
    err = (got - stream_sum_plain(base[:nb], 8)).abs().max().item()
    if err != 0:
        raise AssertionError(f"stream_sum over the base: off by {err}")
    streams.append(dict(shape=list(base[:nb].shape), G=8, extra=False, base=True,
                        max_abs_err=err,
                        **timed(lambda: stream_sum(base[:nb], 8), base[:nb].numel())))
    out["stream"] = streams

    # 3. K1 full, nodot and noscale at the headline workload
    D = 64
    live, h = band_operands(dbg, D, 1)
    sub = mirror_sub(dbg, live, h)
    nbytes = band_pass_bytes(dbg, D)
    k1 = {}
    for diag in ("full", "nodot", "noscale"):
        def call(diag=diag):
            return bk.spmm_band(dbg, live, live, h, sub, diag=diag)

        ref = (bk.spmm_band_plain(dbg, live, live, h, sub) if diag == "full"
               else bk.spmm_band_diag_plain(dbg, live, live, h, sub, diag))
        err = (call() - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= KERNEL_TOL * max(scale, 1e-30):
            raise AssertionError(f"K1 diag={diag}: {err} against max|ref| {scale}")
        del ref
        k1[diag] = dict(max_abs_err=err, **timed(call, nbytes))
    out["k1"] = dict(pad_n=dbg.pad_n, C=dbg.C, bytes_per_pass=nbytes, D=D, **k1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
