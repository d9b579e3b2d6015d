"""Synthetic band workloads of the kernel probes (probe_hbm_roof, tune_band,
bench_nibble).

The port's own copies of the JAX package's probe generators: bench.py's
`ring_powerlaw_edges` (the headline kernel workload, 2^20 nodes and 2^22
edges), scripts/bench_nibble.py's `dedupe` (its simple-graph variant, whose
band values fit a nibble) and scripts/proto_band_v4.py's clipped heavier-tail
generator.  `ring_band_graph` builds one layer's symmetric DenseBandGraph of
such a workload, and `band_operands` draws a probe's scales and features.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mdcommunity_tpu_torch.ops.dense_band import DenseBandGraph, build_dense_band


def ring_powerlaw_edges(n: int, e: int, rng: np.random.Generator, alpha: float = 2.5,
                        scale: float = 8.0) -> Tuple[np.ndarray, np.ndarray]:
    """Directed edges with circular power-law offsets (a locality-ordered
    geometric graph surrogate; alpha matches the GMM generator's T = 0.4
    tail).  bench.py's generator, draw for draw."""
    src = rng.integers(0, n, e).astype(np.int64)
    off = (scale * (rng.pareto(alpha, e) + 1.0)).astype(np.int64)
    off = np.minimum(off, n // 2 - 1) * rng.choice(np.array([-1, 1]), e)
    dst = (src + off) % n
    return src, dst


def clipped_powerlaw_edges(n: int, e: int, rng: np.random.Generator
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """scripts/proto_band_v4.py's workload: offsets with the heavier pareto
    1.5 tail, clipped at the ends of [0, n) instead of wrapped."""
    src = rng.integers(0, n, e).astype(np.int64)
    off = (8.0 * (rng.pareto(1.5, e) + 1.0)).astype(np.int64)
    off = np.minimum(off, n - 1) * rng.choice(np.array([-1, 1]), e)
    dst = np.clip(src + off, 0, n - 1)
    return src, dst


def dedupe(src: np.ndarray, dst: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The distinct (src, dst) pairs, in key order (scripts/bench_nibble.py):
    the random generator repeats pairs (band values above 7), while the
    framework's graphs are simple, the nibble storage's domain."""
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def ring_band_graph(n: int, e: int, S: int = 256, B: int = 128, seed: int = 0,
                    simple: bool = False, nibble: bool = False, scale: float = 8.0,
                    clipped: bool = False, device: str = "cuda") -> DenseBandGraph:
    """One layer's symmetric band build of e random edges over n nodes
    (ring_powerlaw_edges, or clipped_powerlaw_edges; simple=True dedupes
    them), drawn from np.random.default_rng(seed), stored in nibbles with
    nibble=True."""
    rng = np.random.default_rng(seed)
    src, dst = (clipped_powerlaw_edges(n, e, rng) if clipped
                else ring_powerlaw_edges(n, e, rng, scale=scale))
    if simple:
        src, dst = dedupe(src, dst, n)
    return build_dense_band(np.concatenate([src, dst]), np.concatenate([dst, src]), n,
                            S=S, B=B, device=device, nibble=nibble)


def band_operands(dbg: DenseBandGraph, D: int, seed: int):
    """(live, h) for a probe on `dbg`, drawn with numpy from `seed`: live
    f32 [pad_n] (10% of the nodes covered, as the JAX probes' live_scales
    of a random 10% cover; the sum aggregator's row = col = live) and h f32
    [pad_n, D] standard normal, on the graph's device."""
    rng = np.random.default_rng(seed)
    live = (rng.random(dbg.pad_n) >= 0.1).astype(np.float32)
    live[dbg.n:] = 0
    h = rng.standard_normal((dbg.pad_n, D), dtype=np.float32)
    return (torch.from_numpy(live).to(dbg.device),
            torch.from_numpy(h).to(dbg.device).contiguous())
