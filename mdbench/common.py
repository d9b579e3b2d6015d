"""What both kinds of cell share: the run's context, set-up of the graph,
the band and the host env from the run's inputs, the harness's env proxy
(its cascade span), the program's state read back for the reference, and
the reference's comparisons."""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mdbench import gen, reference as ref


@dataclasses.dataclass
class Ctx:
    """One run: what the harness was asked, what set-up made, and what the
    window and the check found.  `layer` holds what the per-layer readers
    read (mdbench/metrics/<name>.py)."""

    root: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    n: int
    t_process: float
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    layer: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: List[dict] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    phases: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """Seconds since the previous mark (or the process's start), under
        `name`: set-up's phases and the check's time, for standard error."""
        now = time.perf_counter()
        last = self.phases[-1][2] if self.phases else self.t_process
        self.phases.append((name, now - last, now))

    def check(self, name: str, value: float, limit: float) -> bool:
        ok = bool(math.isfinite(value) and value <= limit)
        self.checks.append({"name": name, "value": float(value), "limit": float(limit), "ok": ok})
        return ok

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["ok"] for c in self.checks)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Setup:
    """The program's objects for one run, and the inputs both sides get."""

    edges: tuple               # per layer [M, 2], original ids
    weights: Optional[np.ndarray]
    banded: Any
    perm: np.ndarray           # band position -> original id
    env_weights: Optional[np.ndarray]
    ordered: tuple             # the build's band-order edges (the env's)
    net: Any
    ckpt: str


def build(ctx: Ctx) -> Setup:
    """The run's inputs from the seed, then the program's build (ordering,
    band, host env inputs) and the configuration's checkpoint."""
    from mdcommunity_tpu_torch.graphs.banded import build_banded_duplex
    from mdcommunity_tpu_torch.models.checkpoint import load_model

    ctx.mark("imports")
    edges, w = gen.make_inputs(ctx.traffic, ctx.config, ctx.seed, ctx.n)
    ctx.mark("inputs")
    banded, perm, ordered = build_banded_duplex(ctx.n, edges[0], edges[1], device=ctx.device,
                                                weights=w)
    ctx.mark("band build")
    env_w = None if w is None else np.ascontiguousarray(w[:, perm], np.float64)
    ckpt = checkpoint(ctx.root, ctx.config)
    net = load_model(ckpt, device=ctx.device)
    ctx.mark("checkpoint")
    return Setup(edges, w, banded, np.asarray(perm, np.int64), env_w, ordered, net, ckpt)


def checkpoint(root: str, config: dict) -> str:
    """The configuration's released checkpoint, refused unless its bytes
    are the ones the configuration names (a checkpoint that changed would
    change the picks, and so the work, unseen)."""
    path = os.path.join(root, config["checkpoint"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != config["checkpoint_sha256"]:
        raise ValueError(f"{config['checkpoint']} is not the checkpoint that "
                         f"{config['name']} names (sha256 {digest})")
    return path


def host_env(ctx: Ctx, s: Setup):
    from mdcommunity_tpu_torch.env.host_env import make_host_env

    env = make_host_env(ctx.n, s.ordered[0], s.ordered[1], weights=s.env_weights,
                        engine="native")
    ctx.mark("host env")
    return env


class EnvProxy:
    """The harness's env: the program's host env, with a span around each
    cascade (step_many) and a stop.  Once stopped, step_many removes
    nothing and the env reads as terminal, so the program's loop ends at
    its next test."""

    def __init__(self, env, tracing: bool):
        self.__dict__.update(_env=env, stopped=False, cascade_s=[], tracing=tracing,
                             before_step=None, after_step=None)

    def __getattr__(self, name):
        return getattr(self._env, name)

    @property
    def terminal(self) -> bool:
        return self.stopped or self._env.terminal

    def step_many(self, actions, degree_cost: bool = False):
        if self.stopped:
            empty = np.zeros((0, 2), np.int64)
            return self._env.rank, [empty, empty], 0
        if self.before_step is not None:
            self.before_step(actions)
        t0 = time.perf_counter()
        if self.tracing:
            with torch.autograd.profiler.record_function("mdbench.cascade"):
                out = self._env.step_many(actions, degree_cost=degree_cost)
        else:
            out = self._env.step_many(actions, degree_cost=degree_cost)
        self.cascade_s.append(time.perf_counter() - t0)
        if self.after_step is not None:
            self.after_step(actions)
        return out


@dataclasses.dataclass
class EnvState:
    """The program's env state as read back: covered, sever masks over its
    own edge arrays, rank."""

    covered: np.ndarray
    sever: List[np.ndarray]
    rank: int


def read_state(env) -> EnvState:
    return EnvState(np.array(env.covered, copy=True), [m.copy() for m in env.sever],
                    int(env.rank))


def bands_of(banded) -> list:
    """The two layers' bands as numbers (roofline.Band), the band's stored
    nonzeros counted now."""
    from mdbench.roofline import Band

    out = []
    for layer in range(2):
        d = banded.dbg(layer)
        nnz = int((d.base[:, : d.S] != 0).sum().item())
        out.append(Band(d.n_blocks, d.S, d.C, d.pad_n, d.W2, nnz, bool(d.nibble)))
    return out


# ---------------------------------------------------------------- the check


class Judge:
    """The reference's side of a run: the intact graph, the weights and the
    mapping of the program's ids and edge arrays onto the reference's."""

    def __init__(self, ctx: Ctx, s: Setup, env_edges: List[np.ndarray]):
        self.ctx = ctx
        self.n = ctx.n
        self.edges = s.edges
        self.weights = s.weights
        self.perm = s.perm
        if not np.array_equal(np.sort(self.perm), np.arange(self.n)):
            raise AssertionError("the build's order is not a permutation of the nodes")
        self.intact = ref.intact_state(self.n, self.edges)
        self.cfg_ref = ref.config_reference(ctx.config["name"])
        self.params = ref.read_params(s.ckpt)
        self.dev = ctx.device
        self._start = None
        # each of the env's edges -> its unique pair in the reference
        self.edge_idx = []
        for layer, e in enumerate(env_edges):
            keys = ref.pair_keys(self.perm[np.asarray(e, np.int64)])
            lk = self.intact.layers[layer].keys
            idx = np.searchsorted(lk, keys)
            if np.any(idx >= len(lk)) or np.any(lk[np.minimum(idx, len(lk) - 1)] != keys):
                raise AssertionError("the env's edges are not the generated edges")
            self.edge_idx.append(idx)

    def to_ref(self, st: EnvState) -> tuple:
        """(reference State, entries in which duplicate edges disagree)."""
        out = self.intact.copy()
        bad = 0
        for layer, L in enumerate(out.layers):
            cnt = np.bincount(self.edge_idx[layer], weights=st.sever[layer],
                              minlength=len(L.u)).astype(np.int64)
            bad += int(np.sum((cnt != 0) & (cnt != L.mult.astype(np.int64))))
            L.sev = cnt > 0
        cov = np.zeros(self.n, bool)
        cov[self.perm] = st.covered[: self.n]
        out.covered = cov
        out.rank = st.rank
        return out, bad

    def start(self) -> "ref.State":
        """The reference's cascade of the intact graph (made once)."""
        if self._start is None:
            self._start = ref.cascade(self.intact.copy())
        return self._start.copy()

    def start_gap(self, st0: EnvState) -> int:
        """The program's state before its first batch against the
        reference's cascade of the intact graph."""
        mine = self.start()
        theirs, bad = self.to_ref(st0)
        return ref.state_gap(mine, theirs) + bad

    def cascade_gap(self, pre: EnvState, acts_band: np.ndarray, post: EnvState) -> int:
        """The reference's cascade from the program's state before a batch,
        against the program's state after it."""
        start, bad0 = self.to_ref(pre)
        mine = ref.cascade(start, self.perm[np.asarray(acts_band, np.int64)])
        theirs, bad1 = self.to_ref(post)
        return ref.state_gap(mine, theirs) + bad0 + bad1

    def q_ref(self, state: "ref.State", params=None) -> torch.Tensor:
        p = ref.tensors(params or self.params, self.dev)
        with torch.no_grad():
            inp = ref.inputs(state, [len(e) for e in self.edges], self.weights, self.cfg_ref,
                             self.dev)
            return ref.q_values(p, inp)

    def q_gaps(self, q_band: torch.Tensor, acts_band: np.ndarray, q_r: torch.Tensor,
               k: int, of: Optional[int] = None) -> tuple:
        """(Q error, pick gap) of one model call: the largest |Q − Q_ref|
        over the reference's active nodes, and the most by which a picked
        node's reference Q lies below the reference's k-th best, both over
        max |Q_ref|; inf where the active sets differ or the batch is short.
        With `of`, the picks are some of the call's best `of` (a training
        step's greedy picks), held against the reference's `of`-th best."""
        q_r = q_r.double().cpu()
        qp = torch.empty(self.n, dtype=torch.float64)
        qp[torch.from_numpy(self.perm)] = q_band[: self.n].double().cpu()
        act = torch.isfinite(q_r)
        if not torch.equal(act, torch.isfinite(qp)) or not bool(act.any()):
            return math.inf, math.inf
        scale = float(q_r[act].abs().max())
        scale = scale if scale > 0 else 1.0
        q_err = float((qp[act] - q_r[act]).abs().max()) / scale
        picks = torch.from_numpy(self.perm[np.asarray(acts_band, np.int64)])
        want = min(k if of is None else of, int(act.sum()))
        if len(picks) < (want if of is None else 1) or len(torch.unique(picks)) != len(picks):
            return q_err, math.inf
        tau = float(torch.topk(q_r[act], len(picks) if of is None else want).values[-1])
        gap = max(0.0, tau - float(q_r[picks].min())) / scale
        return q_err, gap


def no_jax_modules() -> List[str]:
    """Modules whose whole top-level name is JAX's or the JAX package's."""
    import sys

    banned = {"jax", "jaxlib", "flax", "mdcommunity_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)
