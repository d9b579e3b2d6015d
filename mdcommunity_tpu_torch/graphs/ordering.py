"""Bandwidth-reducing node orderings for the dense-band aggregation engine.

A numpy/scipy copy of the JAX package's orderings: the port's band build must
pick the same permutation, because the ordering decides the band, the mirror
capacity C and the spill (ops/dense_band.py).  Locality in the node numbering
is what keeps edges in band: GMM synthetic graphs are banded under angular
order by construction, and real multiplex networks (testReal datasets, up to
~56k nodes) become banded after a reverse Cuthill-McKee pass over the union of
both layers' edges.

The reference never reorders (networkx dict-order graphs,
MultiDismantler_torch.read_multiplex :602-635); this module is
layout preparation for the band engine, with no reference analogue.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def rcm_order(src_layers, dst_layers, n: int) -> np.ndarray:
    """Permutation `perm` (new position -> old id) minimizing the bandwidth of
    the UNION of the given layers' adjacencies (both duplex layers must share
    one ordering: the cascade couples them node-wise)."""
    rows = np.concatenate([np.asarray(s, np.int64) for s in src_layers])
    cols = np.concatenate([np.asarray(d, np.int64) for d in dst_layers])
    data = np.ones(len(rows), np.int8)
    a = sp.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()
    a = a + a.T
    return np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True), np.int64)


def apply_order(
    perm: np.ndarray, src: np.ndarray, dst: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Relabel edge endpoints under `perm` (new position -> old id)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv[np.asarray(src, np.int64)], inv[np.asarray(dst, np.int64)]


def bandwidth(src: np.ndarray, dst: np.ndarray) -> int:
    """Max |src - dst| — the quantity RCM minimizes; fill ~ S^2 * density when
    the band fits in a few source blocks per destination block."""
    if len(src) == 0:
        return 0
    return int(np.abs(np.asarray(src, np.int64) - np.asarray(dst, np.int64)).max())


def band_miss_fraction(
    src: np.ndarray, dst: np.ndarray, n: int, B: int
) -> float:
    """Fraction of edges whose CIRCULAR offset exceeds B — the
    ordering-quality proxy for the circular dense-band layout (offset <= B
    is guaranteed in-band regardless of block alignment; larger offsets are
    mirror/spill candidates)."""
    if len(src) == 0:
        return 0.0
    d = np.abs(np.asarray(src, np.int64) - np.asarray(dst, np.int64))
    d = np.minimum(d, n - d)
    return float(np.mean(d > B))


def ring_seriation_order(
    src_layers,
    dst_layers,
    n: int,
    sweeps: int = 120,
    init_perm: np.ndarray = None,
) -> np.ndarray:
    """Circular barycenter seriation: refine an initial arrangement by
    repeatedly moving each node to the CIRCULAR MEAN angle of its neighbors,
    re-spreading to uniform ranks after every sweep.

    Why: RCM (BFS-based) collapses on small-world graphs — a handful of
    long-range edges makes BFS levels explode, so the r03 1M probe measured
    ~11% of a shuffled-id ring-local graph's edges spilling out of
    band+mirror under RCM.  The underlying structure is CIRCULAR (the GMM's
    S1 geometry, ring-offset surrogates), and pure spectral sequencing
    cannot recover it either (the ring harmonics sit in a near-continuous
    top spectrum with O(1/n²) gaps — power iteration would need O(n²)
    steps).  The barycenter sweep is the classic seriation self-consistent
    field: θ_v ← atan2(Σ_u sin θ_u, Σ_u cos θ_u) over neighbors u, then
    θ ← 2π·rank(θ)/n (the re-ranking prevents collapse and keeps a valid
    circular arrangement, which the band layout's mod-pad_n windows accept
    at any rotation).  Warm start required: from RCM it reduced the 2^17
    shuffled ring-surrogate's band-miss from 0.21 to 0.007 in 120 sweeps
    (one sparse matvec each); from random init it does not find the ring.
    No reference analogue (the reference never reorders).

    Returns perm (new position -> old id)."""
    rows = np.concatenate([np.asarray(s, np.int64) for s in src_layers])
    cols = np.concatenate([np.asarray(d, np.int64) for d in dst_layers])
    a = sp.coo_matrix(
        (np.ones(len(rows), np.float64), (rows, cols)), shape=(n, n)
    ).tocsr()
    a = a + a.T
    if init_perm is None:
        init_perm = rcm_order(src_layers, dst_layers, n)
    inv = np.empty(n, np.int64)
    inv[init_perm] = np.arange(n)
    theta = 2.0 * np.pi * inv / n
    order = init_perm
    for _ in range(sweeps):
        c = a @ np.cos(theta)
        s = a @ np.sin(theta)
        # isolated nodes (c == s == 0) keep their angle via the +theta tiebreak
        keep = (c == 0.0) & (s == 0.0)
        new = np.arctan2(s, c)
        theta = np.where(keep, theta, new)
        order = np.argsort(theta, kind="stable").astype(np.int64)
        r = np.empty(n, np.int64)
        r[order] = np.arange(n)
        theta = 2.0 * np.pi * r / n
    return order


def best_band_order(
    src_layers, dst_layers, n: int, B: int, rcm_ok: float = 0.02
) -> np.ndarray:
    """Pick the ordering with the fewest band misses: input order as-is, RCM,
    and (only when both leave > rcm_ok of edges out of the guaranteed band —
    the small-world failure mode) circular barycenter seriation warm-started
    from the better of the two.  Evaluated by band_miss_fraction on the
    union edge set."""
    rows = np.concatenate([np.asarray(s, np.int64) for s in src_layers])
    cols = np.concatenate([np.asarray(d, np.int64) for d in dst_layers])

    def miss(perm):
        s2, d2 = apply_order(perm, rows, cols)
        return band_miss_fraction(s2, d2, n, B)

    ident = np.arange(n, dtype=np.int64)
    cands = [(miss(ident), 0, ident)]
    rcm = rcm_order(src_layers, dst_layers, n)
    cands.append((miss(rcm), 1, rcm))
    if min(c[0] for c in cands) > rcm_ok:
        cands.sort(key=lambda c: (c[0], c[1]))
        ser = ring_seriation_order(
            src_layers, dst_layers, n, init_perm=cands[0][2]
        )
        cands.append((miss(ser), 2, ser))
    cands.sort(key=lambda c: (c[0], c[1]))
    return cands[0][2]
