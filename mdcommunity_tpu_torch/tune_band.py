"""Where K1's time goes: its timing variants, its block-size operating
points, and the JAX package's two band prototypes.

The port's counterpart of the JAX package's scripts/tune_band_packed.py
--diag (:149-162), scripts/sweep_band_sg.py, scripts/proto_band_pallas.py
and scripts/proto_band_v4.py, on kernel K1 (ops/band_kernels.spmm_band):

  --diag   K1 full, noscale, nodot, noh and hlin (csrc/band.cu's DIAG
           variants: no scales; staging without multiply-adds; no h staging
           either; each block staging only its own rows) at the headline
           workload (2^20 nodes, 2^22 random ring edges, S = 256, B = 128,
           D = 64), in the f32 and the bf16 mode;
  --sweep  full and nodot at (S, B) in {128, 256, 512} x {128}, both modes;
  --proto  the prototypes' function, K1's bf16 mode at unit scales with a
           zero mirror table (bf16(A_band) @ bf16(h), f32 sums), at their
           workloads: proto_band_pallas.py's (2^17 nodes, 2^19 edges, S =
           512, B = 64; its C extra output rows are the mirror compaction
           at col = 1, ops/dense_band.mirror_compact) and proto_band_v4.py's
           (2^18 nodes, 2^20 clipped edges, S/B in 512/256, 256/128, 256/256,
           128/128; h bf16).

Each variant with a defined output (full, noscale, nodot, the prototypes)
is first held to its plain version, to 1e-4 of max|ref| (f32 sums in
another order); noh and hlin are launched and counted.  The prototypes'
rows also carry their bound, plain and library times and K1's launches.
Times are CUDA events, median of --reps after warm-ups, with the card's
name and power limit.  Prints one JSON line.  On the CPU (--device cpu, a small --n) it
runs the checks at n nodes and times nothing; noh and hlin need the card.

    python -m mdcommunity_tpu_torch.tune_band --diag --sweep --proto
    python -m mdcommunity_tpu_torch.tune_band --diag --device cpu --n 4096
"""

from __future__ import annotations

import argparse
import json

TOL = 1e-4
PEAK_BF16_S = 989e12   # H100 SXM bf16 tensor cores, dense (data sheet)
DIAG_ORDER = ("full", "noscale", "nodot", "noh", "hlin")
SWEEP = ((128, 128), (256, 128), (512, 128))
PROTO_V4 = ((512, 256), (256, 128), (256, 256), (128, 128))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--diag", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--proto", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="nodes of the headline workload (4n edges); the "
                         "prototypes' workloads scale by n / 2^20")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args(argv)
    if not (args.diag or args.sweep or args.proto):
        ap.error("name at least one of --diag, --sweep, --proto")

    import torch

    from mdcommunity_tpu_torch.graphs.synth import band_operands, ring_band_graph
    from mdcommunity_tpu_torch.ops import band_kernels as bk
    from mdcommunity_tpu_torch.ops.dense_band import band_rows, mirror_compact, mirror_sub
    from mdcommunity_tpu_torch.utils.device import resolve_device
    from mdcommunity_tpu_torch.utils.timing import PEAK_BYTES_S, cuda_ms, gpu_line

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    D = 64

    def ms(fn):
        return cuda_ms(fn, args.reps, args.warm) if on_card else None

    def check(name, got, ref):
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not err <= TOL * max(scale, 1e-30):
            raise AssertionError(f"{name}: {err} against max|ref| {scale}")
        return err

    def variants(dbg, diags, modes=(True, False)):
        """{mode: {diag: {ms, max_abs_err}}} of K1 on dbg."""
        live, h = band_operands(dbg, D, 1)
        res = {}
        for precise in modes:
            sub = mirror_sub(dbg, live, h, precise)
            row = {}
            for diag in diags:
                if diag in ("noh", "hlin") and not on_card:
                    continue   # no defined output, no plain version

                def call(diag=diag):
                    return bk.spmm_band(dbg, live, live, h, sub, precise=precise, diag=diag)

                err = None
                if diag not in ("noh", "hlin"):
                    ref = (bk.spmm_band_plain(dbg, live, live, h, sub, precise)
                           if diag == "full" else
                           bk.spmm_band_diag_plain(dbg, live, live, h, sub, diag, precise))
                    err = check(f"K1 {diag} precise={precise}", call(), ref)
                    del ref
                else:
                    call()
                row[diag] = dict(ms=ms(call), max_abs_err=err)
            res["f32" if precise else "bf16"] = row
        return res

    out = dict(probe="tune_band", n=args.n, device=str(device), gpu=gpu_line(), D=D)
    if args.diag:
        dbg = ring_band_graph(args.n, 4 * args.n, device=str(device))
        out["diag"] = dict(S=dbg.S, B=dbg.B, C=dbg.C, pad_n=dbg.pad_n,
                           **variants(dbg, DIAG_ORDER))
    if args.sweep:
        sweep = []
        for S, B in SWEEP:
            dbg = ring_band_graph(args.n, 4 * args.n, S=S, B=B, device=str(device))
            sweep.append(dict(S=S, B=B, W2=dbg.W2, C=dbg.C,
                              base_mb=dbg.base.numel() / 1e6,
                              **variants(dbg, ("full", "nodot"))))
            del dbg
        out["sweep"] = sweep
    if args.proto:
        frac = args.n / (1 << 20)
        protos = []

        def proto(label, dbg, h, with_mirror):
            """The prototype's function on dbg: K1's bf16 mode at unit scales
            with a zero mirror table (and, with_mirror, the mirror
            compaction at col = 1), held to its plain version and timed
            beside its bound (the band rows and h read once, the output and
            mirror rows written once; the band's multiply-adds at the bf16
            tensor-core rate), its plain version and the library yardstick
            (torch.bmm of the bf16 band against the bf16 windows)."""
            ones = torch.ones(dbg.pad_n, device=device)
            zero = torch.zeros(dbg.n_blocks * dbg.C, D, device=device)

            def call(kern=True):
                k1 = bk.spmm_band if kern else bk.spmm_band_plain
                o = k1(dbg, ones, ones, h, zero, precise=False)
                if with_mirror:
                    return o, mirror_compact(dbg, ones, h, precise=False)
                return o, None

            before = bk.launches["band_spmm_bf16"]
            got, mir = call()
            err = check(f"{label} S={dbg.S} B={dbg.B}", got, call(kern=False)[0])
            band = band_rows(dbg)
            out_rows = dbg.pad_n + (dbg.n_blocks * dbg.C if with_mirror else 0)
            t_b = (band.numel() + dbg.pad_n * D * 4 + out_rows * D * 4) / PEAK_BYTES_S
            t_o = 2 * int(band.ne(0).sum().item()) * D / PEAK_BF16_S
            lib = None
            if on_card:
                base = band.to(torch.bfloat16)
                win = bk._windows(h.to(torch.bfloat16), dbg.n_blocks, dbg.S,
                                  dbg.B).contiguous()
                lib = ms(lambda: torch.bmm(base, win))
                del base, win
            row = dict(label=label, n=dbg.n, S=dbg.S, B=dbg.B, C=dbg.C, max_abs_err=err,
                       ms=ms(call), k1_ms=ms(lambda: bk.spmm_band(dbg, ones, ones, h, zero,
                                                                  precise=False)),
                       plain_ms=ms(lambda: call(kern=False)), bound_ms=1e3 * max(t_b, t_o),
                       bound_by="bytes" if t_b >= t_o else "operations", library_ms=lib)
            row["launches"] = bk.launches["band_spmm_bf16"] - before
            if with_mirror:
                row["mirror_rows"] = list(mir.shape)
            protos.append(row)

        n_p = max(1 << 10, int((1 << 17) * frac))
        dbg = ring_band_graph(n_p, 4 * n_p, S=512, B=64, device=str(device))
        proto("proto_band_pallas", dbg, band_operands(dbg, D, 2)[1], True)
        n_v = max(1 << 10, int((1 << 18) * frac))
        for S, B in PROTO_V4:
            dbg = ring_band_graph(n_v, 4 * n_v, S=S, B=B, clipped=True, device=str(device))
            h = band_operands(dbg, D, 3)[1].to(torch.bfloat16).float()
            proto("proto_band_v4", dbg, h, False)
            del dbg
        out["proto"] = protos
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
