"""Times variants of the blocked-pair kernels' launch constants on the card.

csrc/blocked.cu fixes, as constexpr ints, K4's threads a block (NT4), live
slots whose rows a team loads at once (U4) and float4 columns a lane (Q4),
and K5's threads a block (NT5), rounds loaded at once (R5) and float4
columns a lane (Q5).
Each variant is a copy of the source with some of them changed, built with
nvcc for sm_90a into _build/tune_blocked/ (all builds at once), loaded in
place of the package's build, held to the plain versions, and timed: K4 and
K5 device time (utils/timing.device_ms, REPS calls) on the RCM-ordered
blocked layouts of 18,222 and 2^20 nodes (chip_smoke.blocked_graph, D = 64).
The variants run in order and then in reverse, so each has two times a
size, taken in one process on one card.  Prints one JSON line with the
card's name and power limit.  Needs the card.

    python -m mdcommunity_tpu_torch.tune_blocked
    python -m mdcommunity_tpu_torch.tune_blocked --variants base U4=4,Q4=1 R5=2
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading

REPS, WARM = 50, 5
# a variant is "base" (the source as it stands) or NAME=value[,NAME=value...]
VARIANTS = ("base", "U4=8,Q4=1,NT4=256,R5=2", "U4=4,Q4=1", "U4=3,Q4=1", "U4=3", "U4=4",
            "Q4=4", "NT4=128", "R5=2", "Q5=1", "NT5=128")


def parse_variant(name: str) -> dict:
    """{constant: value} of a variant's name."""
    if name == "base":
        return {}
    consts = {}
    for part in name.split(","):
        key, _, value = part.partition("=")
        if key not in ("NT4", "U4", "Q4", "NT5", "R5", "Q5") or not value.isdigit():
            raise ValueError(f"not a variant: {name}")
        consts[key] = int(value)
    return consts


def variant_source(text: str, consts: dict) -> str:
    """The source with each `constexpr int NAME = v;` of consts replaced."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"blocked.cu has no single constant {name}")
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    help="base, or NAME=value[,NAME=value] of NT4, U4, Q4, NT5, R5, Q5")
    args = ap.parse_args(argv)
    consts = {name: parse_variant(name) for name in args.variants}
    root = os.getcwd()
    if not os.path.exists(os.path.join(root, "chip_smoke.py")):
        sys.exit("run from the root of a checkout (chip_smoke.py's directory)")
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_blocked needs the card")
    import chip_smoke as cs

    from mdcommunity_tpu_torch.ops import blocked_kernels as bk
    from mdcommunity_tpu_torch.ops.cuda_build import BUILD_DIR, build_library
    from mdcommunity_tpu_torch.utils.timing import device_ms, gpu_line

    out_dir = os.path.join(BUILD_DIR, "tune_blocked")
    os.makedirs(out_dir, exist_ok=True)
    with open(bk.SRC) as f:
        text = f.read()
    paths, errors = {}, []
    for name in args.variants:
        tag = re.sub(r"\W", "_", name)
        src = os.path.join(out_dir, f"blocked_{tag}.cu")
        with open(src, "w") as f:
            f.write(variant_source(text, consts[name]))
        paths[name] = (src, os.path.join(out_dir, f"libblocked_{tag}.so"))

    def build(src, lib):
        try:
            build_library(src, lib, force=True)
        except Exception as e:  # reported below, after every build has ended
            errors.append(e)

    threads = [threading.Thread(target=build, args=p) for p in paths.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    libs = {name: bk.bind(lib) for name, (_, lib) in paths.items()}

    times = {name: {} for name in libs}
    for label, n in (("18,432", 18222), ("2^20", 1 << 20)):
        bd = cs.blocked_graph(n, "cuda", max_rank=0)
        bcoo, w, h = cs.blocked_operands(bd, 14, "cuda")
        g = torch.nn.functional.normalize(torch.randn_like(h), dim=-1)
        ref4, ref5 = bk.spmm_block_plain(bcoo, w, h), bk.sddmm_block_plain(bcoo, h, g)
        order = list(libs)
        for name in order + order[::-1]:
            bk._lib = libs[name]
            cs.compare(f"{name} K4 {label}", bk.spmm_block(bcoo, w, h), ref4, quiet=True)
            cs.compare(f"{name} K5 {label}", bk.sddmm_block(bcoo, h, g), ref5, quiet=True)
            t = times[name].setdefault(label, {"K4": [], "K5": []})
            t["K4"].append(device_ms(lambda: bk.spmm_block(bcoo, w, h), REPS, WARM))
            t["K5"].append(device_ms(lambda: bk.sddmm_block(bcoo, h, g), REPS, WARM))
        del bd, bcoo, w, h, g, ref4, ref5
        torch.cuda.empty_cache()
    bk._lib = None
    print(json.dumps(dict(gpu=gpu_line(), reps=REPS, device_ms=times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
