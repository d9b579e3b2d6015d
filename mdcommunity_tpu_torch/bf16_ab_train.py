"""Training-quality A/B of the fast dense layers against f32: the port's
counterpart of scripts/bf16_ab_train.py.

Two unit-cost runs of the small-graph trainer (rl/dqn.DQNAgent, seed 0, the
same schedule) that differ only in Config.dtype: "float32" runs the dense
layers in true f32 (TF32 off), "bfloat16" under
utils/device.matmul_precision(False), TF32 on the card (rl/dqn.py's
DQNAgent._prec).  Each arm is its own child process (the precision flags
are process-wide); the two run side by side on the card.  Each writes its
run into --out (by default runs/bf16_ab/, which .gitignore lists), never
into models_tpu/, and the parent prints both validation-cost curves
(ModelVC_*.csv, a point every --save-frequency iterations from iteration
0) as one JSON line with the card's line.  On the CPU (--cpu) the flags
change nothing, so the curves agree.

    python -m mdcommunity_tpu_torch.bf16_ab_train [--iters 4000] [--out runs/bf16_ab] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = (("float32", "f32"), ("bfloat16", "bf16"))
TIMEOUT_S = 7200.0   # for both arms together (4,000 iterations take minutes)


def agent_config(dtype: str, iters: int, save_frequency=None, smoke: bool = False):
    """The arm's Config: unit cost, seed 0, max_iteration = iters, the given
    dtype (Config.smoke's sizes with smoke)."""
    from mdcommunity_tpu_torch.utils.config import Config

    cfg = Config(variant="unit_cost", seed=0)
    cfg = cfg.smoke if smoke else cfg
    return dataclasses.replace(cfg, max_iteration=iters, dtype=dtype,
                               save_frequency=save_frequency or cfg.save_frequency)


def vc_curve(save_dir: str, cfg) -> list:
    """The validation costs the run wrote, in order."""
    with open(os.path.join(save_dir, f"ModelVC_{cfg.num_min}_{cfg.num_max}.csv")) as f:
        return [float(x) for x in f]


def child(args) -> None:
    """One arm: DQNAgent(cfg, seed 0).train into its directory."""
    import torch

    from mdcommunity_tpu_torch.rl.dqn import DQNAgent
    from mdcommunity_tpu_torch.utils.device import set_precise_matmul

    set_precise_matmul()   # the f32 arm's default; the bf16 arm's agent scopes TF32 on
    cfg = agent_config(args.child, args.iters, args.save_frequency, args.smoke)
    device = "cpu" if args.cpu else None
    if device == "cpu":
        torch.set_num_threads(1)
    DQNAgent(cfg, seed=0, device=device).train(save_dir=args.save_dir, log=lambda *a: None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=4000)
    ap.add_argument("--out", default=os.path.join(REPO, "runs", "bf16_ab"))
    ap.add_argument("--save-frequency", type=int, default=None,
                    help="iterations between validations (Config's by default)")
    ap.add_argument("--smoke", action="store_true", help="Config.smoke's sizes")
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    ap.add_argument("--child", choices=[a for a, _ in ARMS], help=argparse.SUPPRESS)
    ap.add_argument("--save-dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args)
        return None
    import torch

    from mdcommunity_tpu_torch.utils.timing import gpu_line

    if not args.cpu and not torch.cuda.is_available():
        sys.exit("CUDA is not available: pass --cpu")
    common = ["--iters", str(args.iters)] + (["--smoke"] if args.smoke else []) + \
        (["--cpu"] if args.cpu else []) + \
        (["--save-frequency", str(args.save_frequency)] if args.save_frequency else [])
    dirs, procs, texts = {}, [], []
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        logs = []
        try:
            for dtype, tag in ARMS:
                dirs[tag] = os.path.join(args.out, f"unit_cost_{tag}")
                os.makedirs(dirs[tag], exist_ok=True)
                logs.append(stack.enter_context(
                    open(os.path.join(dirs[tag], "train.log"), "w+")))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "mdcommunity_tpu_torch.bf16_ab_train", "--child",
                     dtype, "--save-dir", dirs[tag]] + common,
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=REPO))
            for p in procs:
                p.wait(timeout=max(TIMEOUT_S - (time.perf_counter() - t0), 1.0))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for log in logs:
            log.seek(0)
            texts.append(log.read())
    for (_, tag), p, text in zip(ARMS, procs, texts):
        if p.returncode:
            raise RuntimeError(f"the {tag} arm exited with code {p.returncode}:\n{text[-4000:]}")
    cfg = agent_config("float32", args.iters, args.save_frequency, args.smoke)
    out = dict(iters=args.iters, save_frequency=cfg.save_frequency, variant="unit_cost",
               seed=0, device="cpu" if args.cpu else "cuda", card=gpu_line(),
               wall_s=time.perf_counter() - t0,
               **{tag: vc_curve(dirs[tag], cfg) for _, tag in ARMS})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
