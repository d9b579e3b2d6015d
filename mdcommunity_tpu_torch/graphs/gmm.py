"""Geometric Multiplex Model (GMM) synthetic duplex-graph generator.

Two correlated layers of an S1 geometric random graph: each node gets a
hidden degree kappa (power law, exponent gamma) and an angular position
theta; layer-2 kappas/thetas are correlated copulas of layer-1's with
strengths nu and g.  Connection probability is the Fermi-Dirac form
1 / (1 + (d/(mu*k*k'))^(1/T)).  Model and defaults follow the reference
(GMM.py:6-68, Hyperbolic.py:18-117): L=2, nu=0.2, g=0.5, gamma=2.5,
kbar ~ U(2,10) per layer, T=0.4; the degree-cost variant pins kbar=6.

A copy of the JAX package's graphs/gmm.py: the same numpy calls in the same
order, so a seed gives the same graphs in both packages.  For
n >= _NATIVE_CONNECT_MIN_N the pair loop runs in the port's copy of the C++
engine (native/, mdc_gmm_connect), seeded from the rng, as the JAX package
does; without a C++ toolchain both packages fall back to numpy, whose
stream differs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.special import erf, erfinv, lambertw

# below this size the numpy pair kernel wins (and keeps the training-pool RNG
# stream byte-identical to the committed results); above it the C++ streaming
# connector avoids the O(N^2) temporaries
_NATIVE_CONNECT_MIN_N = 512


def _kmin(kbar: float, gamma: float) -> float:
    return kbar * (gamma - 2.0) / (gamma - 1.0)


def _mu(kbar: float, T: float) -> float:
    return np.sin(T * np.pi) / (2.0 * np.pi * T * kbar)


def sample_kappa(rng: np.random.Generator, n: int, kmin: float, gamma: float) -> np.ndarray:
    """Pareto hidden degrees: kmin * (1-u)^(1/(1-gamma))."""
    u = rng.random(n)
    return kmin * np.power(1.0 - u, 1.0 / (1.0 - gamma))


def sample_conditional_kappa(
    rng: np.random.Generator,
    nu: float,
    kappa1: np.ndarray,
    kmin1: float,
    gamma1: float,
    kmin2: float,
    gamma2: float,
) -> np.ndarray:
    """Layer-2 kappas correlated with layer-1 via the Lambert-W copula
    (Hyperbolic.py:44-64)."""
    n = len(kappa1)
    if nu == 1:
        return kmin2 * np.power(kappa1 / kmin1, (1.0 - gamma1) / (1.0 - gamma2))
    if nu == 0:
        return sample_kappa(rng, n, kmin2, gamma2)
    phi = -np.log(1.0 - np.power(kmin1 / kappa1, gamma1 - 1.0))
    z = (
        (1.0 / kmin1)
        * np.power(phi, nu / (nu - 1.0))
        * np.power(kappa1, -gamma1)
        * (kmin1 * np.power(kappa1, gamma1) - np.power(kmin1, gamma1) * kappa1)
    )
    zr = z * rng.random(n)
    a = nu / (1.0 - nu)
    zr = a * lambertw(np.power(zr, (nu - 1.0) / nu) / a)
    zr = np.power(zr, 1.0 / (1.0 - nu)) - np.power(phi, 1.0 / (1.0 - nu))
    zr = np.exp(-np.power(zr, 1.0 - nu))
    return np.real(kmin2 * np.power(1.0 - zr, 1.0 / (1.0 - gamma2)))


def sample_conditional_theta(
    rng: np.random.Generator, g: float, theta1: np.ndarray
) -> np.ndarray:
    """Layer-2 angles: truncated-Gaussian angular displacement of layer-1 angles
    (Hyperbolic.py:66-83)."""
    n = len(theta1)
    two_pi = 2.0 * np.pi
    if g == 1:
        return theta1.copy()
    if g == 0:
        return two_pi * rng.random(n)
    sigma0 = min(n / (4.0 * np.pi), 100.0)
    sigma = sigma0 * (1.0 / g - 1.0)
    u = -1.0 + 2.0 * rng.random(n)
    disp = np.sqrt(2.0) * sigma * erfinv(u * erf(n / (2.0 * np.sqrt(2.0) * sigma)))
    return np.mod(theta1 + two_pi * disp / n, two_pi)


def _connect_layer(
    rng: np.random.Generator,
    kappa: np.ndarray,
    theta: np.ndarray,
    T: float,
    kbar: float,
) -> np.ndarray:
    """Vectorized pairwise Fermi-Dirac connection (Hyperbolic.py:101-117).

    Returns undirected edge array [M, 2].  To reproduce the reference's RNG-call
    pattern is not a goal; the distribution is identical.
    """
    n = len(kappa)
    mu = _mu(kbar, T)
    if n >= _NATIVE_CONNECT_MIN_N:
        # large graphs: stream the pair loop in C++ (no N^2 numpy temporaries);
        # the distribution is identical, only the RNG stream differs
        from mdcommunity_tpu_torch.native import gmm_connect

        seed = int(rng.integers(0, 2**63 - 1))
        edges = gmm_connect(kappa, theta, T, mu, seed)
        if edges is not None:
            return edges
    two_pi = 2.0 * np.pi
    dtheta = np.abs(theta[:, None] - theta[None, :])
    dist = (n / two_pi) * np.abs(np.pi - np.abs(np.pi - dtheta))
    chi = dist / (mu * np.outer(kappa, kappa))
    with np.errstate(over="ignore", divide="ignore"):
        p = 1.0 / (1.0 + np.power(chi, 1.0 / T))
    iu, ju = np.triu_indices(n, k=1)
    keep = rng.random(len(iu)) < p[iu, ju]
    return np.stack([iu[keep], ju[keep]], axis=1).astype(np.int32)


def gmm_duplex_edges(
    n: int,
    rng: Optional[np.random.Generator] = None,
    nu: float = 0.2,
    g: Optional[float] = 0.5,
    gamma1: float = 2.5,
    gamma2: float = 2.5,
    T1: float = 0.4,
    T2: float = 0.4,
    kbar1: Optional[float] = None,
    kbar2: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one duplex graph; returns (edges_layer0, edges_layer1) as [M,2] arrays.

    kbar defaults to U(2,10) per layer (reference GMM.py:17,23); pass kbar=6 for the
    degree-cost variant.
    """
    rng = rng or np.random.default_rng()
    # g=None: per-graph angular correlation ~ U(0,1) — the setting the
    # reference's committed "g0-1" checkpoints were trained with (its GMM.py:12
    # keeps the random.uniform(0,1) draw commented out, pinned to 0.5)
    g = rng.uniform(0.0, 1.0) if g is None else g
    kbar1 = rng.uniform(2.0, 10.0) if kbar1 is None else kbar1
    kbar2 = rng.uniform(2.0, 10.0) if kbar2 is None else kbar2
    kmin1, kmin2 = _kmin(kbar1, gamma1), _kmin(kbar2, gamma2)
    kappa1 = sample_kappa(rng, n, kmin1, gamma1)
    kappa2 = sample_conditional_kappa(rng, nu, kappa1, kmin1, gamma1, kmin2, gamma2)
    theta1 = 2.0 * np.pi * rng.random(n)
    theta2 = sample_conditional_theta(rng, g, theta1)
    e1 = _connect_layer(rng, kappa1, theta1, T1, kbar1)
    e2 = _connect_layer(rng, kappa2, theta2, T2, kbar2)
    return e1, e2


def generate_training_graph(
    rng: np.random.Generator,
    num_min: int,
    num_max: int,
    pad_nodes: int,
    pad_edges: int,
    degree_cost: bool = False,
    prior_feature: str = "none",
    g_corr: Optional[float] = 0.5,
    device=None,
):
    """One padded training DuplexGraph with size ~ U[num_min, num_max], or
    None when it does not fit pad_edges (callers retry).  Its max_rank is a
    0 placeholder: generate_pool computes the intact LMCCs of a whole
    candidate batch in one cascade call."""
    from mdcommunity_tpu_torch.graphs.duplex import build_duplex

    if prior_feature != "none":
        raise NotImplementedError(
            f"prior_feature={prior_feature!r}: the CE and HCA priors are not "
            "ported yet"
        )
    n = int(rng.integers(num_min, num_max + 1))
    kw = dict(kbar1=6.0, kbar2=6.0) if degree_cost else {}
    e0, e1 = gmm_duplex_edges(n, rng, g=g_corr, **kw)
    if 2 * max(len(e0), len(e1)) > pad_edges:
        return None
    weights = _degree_weights(n, e0, e1) if degree_cost else None
    return build_duplex(n, e0, e1, pad_nodes, pad_edges, weights=weights,
                        max_rank=0, device=device)


def _degree_weights(n: int, e0: np.ndarray, e1: np.ndarray) -> np.ndarray:
    """Per-layer node costs = deg/maxdeg on the intact layer
    (reference: MultiDismantler_degree_cost/graph.py:39-51)."""
    w = np.zeros((2, n), np.float32)
    for l, e in enumerate((e0, e1)):
        deg = np.zeros(n, np.float32)
        if len(e):
            np.add.at(deg, e[:, 0], 1.0)
            np.add.at(deg, e[:, 1], 1.0)
        mx = deg.max() if deg.max() > 0 else 1.0
        w[l] = deg / mx
    return w


def generate_pool(
    rng: np.random.Generator,
    count: int,
    num_min: int,
    num_max: int,
    pad_nodes: int,
    pad_edges: int,
    degree_cost: bool = False,
    prior_feature: str = "none",
    g_corr: Optional[float] = 0.5,
    device=None,
) -> List:
    """`count` training graphs on `device` (CUDA unless named), drawn in the
    JAX package's order; graphs whose intact LMCC is 1 are rejected
    (reference: MultiDismantler_torch.py:157-160)."""
    import dataclasses

    from mdcommunity_tpu_torch.env.cascade import intact_max_rank
    from mdcommunity_tpu_torch.graphs.duplex import stack_graphs

    out = []
    attempts = 0
    while len(out) < count and attempts < count * 20:
        batch = []
        while len(batch) < count - len(out) and attempts < count * 20:
            attempts += 1
            g = generate_training_graph(
                rng, num_min, num_max, pad_nodes, pad_edges, degree_cost,
                prior_feature, g_corr, device=device,
            )
            if g is not None:
                batch.append(g)
        if not batch:
            break
        # one cascade call for the whole candidate batch
        ranks = intact_max_rank(stack_graphs(batch))
        for i, g in enumerate(batch):
            if int(ranks[i]) > 1:
                out.append(dataclasses.replace(g, max_rank=ranks[i]))
    return out
