"""Graph I/O: real multiplex `.edges` files and synthetic `.npy` adjacency pairs.

File formats follow the reference:
  * `.edges` multiplex: whitespace rows `layer_id u v [w]`, node ids 1-based,
    self-loops skipped (MultiDismantler_torch.read_multiplex :602-635);
  * synthetic eval: `adj1_<i>.npy` / `adj2_<i>.npy` dense adjacency pairs
    (MultiDismantler_torch.Evaluate :575-576).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from mdcommunity_tpu_torch.graphs.duplex import DuplexGraph, build_duplex


def read_multiplex_edges(path: str, n_nodes: int) -> Dict[int, np.ndarray]:
    """Parse a multiplex .edges file into {layer_id: undirected edges [M, 2]}.

    Node ids become 0-based; self-loops are dropped; layer ids keep their
    1-based file values (dataset tables cite them 1-based, testReal.py)."""
    layers: Dict[int, list] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            lid = int(parts[0])
            u = int(parts[1]) - 1
            v = int(parts[2]) - 1
            if u == v:
                continue
            if not (0 <= u < n_nodes and 0 <= v < n_nodes):
                raise ValueError(f"node id out of range in {path}: {line!r}")
            layers.setdefault(lid, []).append((u, v))
    return {lid: np.asarray(e, np.int32).reshape(-1, 2) for lid, e in layers.items()}


# Real multiplex networks: name -> (filename, N, (layer_a, layer_b)), the list
# of the reference's eval entry (testReal.py:27-68).
REAL_DATASETS = {
    "fb-tw": ("fb-tw.edges", 1043, (1, 2)),
    "EUAirTransportation_multiplex": ("EUAirTransportation_multiplex.edges", 450, (1, 11)),
    "Padgett-Florentine-Families_multiplex": (
        "Padgett-Florentine-Families_multiplex.edges", 16, (1, 2)),
    "humanHIV1_genetic_multiplex": ("humanHIV1_genetic_multiplex.edges", 1005, (1, 5)),
    "Lazega-Law-Firm_multiplex": ("Lazega-Law-Firm_multiplex.edges", 71, (1, 3)),
    "fao_trade_multiplex": ("fao_trade_multiplex.edges", 214, (3, 24)),
    "celegans_connectome_multiplex": ("celegans_connectome_multiplex.edges", 279, (2, 3)),
    "sacchpomb_genetic_multiplex": ("sacchpomb_genetic_multiplex.edges", 4092, (4, 6)),
    "arxiv_netscience_multiplex": ("arxiv_netscience_multiplex.edges", 14488, (4, 8)),
    "homo_genetic_multiplex": ("homo_genetic_multiplex.edges", 18222, (1, 2)),
    "netsci_co-authorship_multiplex": ("netsci_co-authorship_multiplex.edges", 1400, (1, 2)),
}


def variant_structure(n_nodes: int, edges_a: np.ndarray, edges_b: np.ndarray,
                      degree_cost: bool = False, prior_feature: Optional[str] = None,
                      prior_cache: Optional[Tuple[str, str]] = None,
                      hca: bool = False) -> Dict[str, np.ndarray]:
    """The per-node arrays a variant attaches to a graph, in original ids
    (build_duplex's keyword arguments): degree_cost the deg/maxdeg costs
    (weights); prior_feature ("boundary" or "participation") the CE
    community prior (node_feat [2, n], boundary [n]), through the npz cache
    when prior_cache = (cache_dir, cache_id); hca the HCA communities and
    features (comm_id, n_comms, hca_feat)."""
    from mdcommunity_tpu_torch.graphs.gmm import _degree_weights

    out: Dict[str, np.ndarray] = {}
    if degree_cost:
        out["weights"] = _degree_weights(n_nodes, edges_a, edges_b)
    if hca:
        from mdcommunity_tpu_torch.graphs.hca import hca_communities_and_features

        out["comm_id"], out["n_comms"], out["hca_feat"] = hca_communities_and_features(
            n_nodes, edges_a, edges_b)
    if prior_feature and prior_feature != "none":
        from mdcommunity_tpu_torch.graphs.community import cached_duplex_prior, duplex_prior

        if prior_cache:
            out["node_feat"], out["boundary"] = cached_duplex_prior(
                prior_cache[0], prior_cache[1], n_nodes, edges_a, edges_b, prior_feature)
        else:
            out["node_feat"], out["boundary"] = duplex_prior(
                n_nodes, edges_a, edges_b, prior_feature)
    return out


def duplex_from_layers(
    n_nodes: int,
    edges_a: np.ndarray,
    edges_b: np.ndarray,
    pad_nodes: Optional[int] = None,
    pad_edges: Optional[int] = None,
    degree_cost: bool = False,
    prior_feature: Optional[str] = None,
    prior_cache: Optional[Tuple[str, str]] = None,
    hca: bool = False,
    max_rank: Optional[int] = None,
    device=None,
) -> DuplexGraph:
    """Two undirected edge arrays -> padded DuplexGraph on `device` (CUDA
    unless named; reference: Graph_test, graph.py:69-84): nodes padded to a
    multiple of 8, directed edges to a multiple of 128, as the JAX package
    pads them.  degree_cost attaches the deg/maxdeg node costs,
    prior_feature the CE community prior (reference
    _attach_static_comm_prior, CEMultiDismantler/MultiDismantler_torch.py:743;
    prior_cache = (cache_dir, cache_id) reads and writes its npz cache), hca
    the HCA communities and features (variant_structure); max_rank None
    computes it by the cascade."""
    def up(x, m):
        return ((max(int(x), 1) + m - 1) // m) * m

    pad_nodes = pad_nodes or up(n_nodes, 8)
    pad_edges = pad_edges or up(2 * max(len(edges_a), len(edges_b), 1), 128)
    extra = variant_structure(n_nodes, edges_a, edges_b, degree_cost, prior_feature,
                              prior_cache, hca)
    return build_duplex(n_nodes, edges_a, edges_b, pad_nodes, pad_edges,
                        max_rank=max_rank, device=device, **extra)


def real_cache_id(path: str, layer_pair: Tuple[int, int]) -> str:
    """The CE prior cache's id of a real dataset's layer pair, the JAX
    package's: '-' separates the layer ids, since f"{a}{b}" is ambiguous
    ((1, 11) and (11, 1) both give "111")."""
    a, b = layer_pair
    return f"{os.path.basename(path).split('.')[0]}_layers{a}-{b}"


def load_real_duplex(
    path: str,
    n_nodes: int,
    layer_pair: Tuple[int, int],
    degree_cost: bool = False,
    prior_feature: Optional[str] = None,
    prior_cache_dir: Optional[str] = None,
    hca: bool = False,
    max_rank: Optional[int] = None,
    device=None,
) -> DuplexGraph:
    """Load a real multiplex network and select the two coupled layers;
    with prior_cache_dir the CE prior goes through its npz cache there."""
    layers = read_multiplex_edges(path, n_nodes)
    a, b = layer_pair
    ea = layers.get(a, np.zeros((0, 2), np.int32))
    eb = layers.get(b, np.zeros((0, 2), np.int32))
    cache = None
    if prior_cache_dir and prior_feature and prior_feature != "none":
        cache = (prior_cache_dir, real_cache_id(path, layer_pair))
    return duplex_from_layers(n_nodes, ea, eb, degree_cost=degree_cost,
                              prior_feature=prior_feature, prior_cache=cache, hca=hca,
                              max_rank=max_rank, device=device)


def edges_from_dense_adj(adj: np.ndarray) -> np.ndarray:
    """Dense symmetric adjacency -> undirected edge list [M, 2]."""
    iu, ju = np.nonzero(np.triu(adj, k=1))
    return np.stack([iu, ju], axis=1).astype(np.int32)


def load_synthetic_pair(adj1_path: str, adj2_path: str, degree_cost: bool = False,
                        device=None) -> DuplexGraph:
    a1 = np.load(adj1_path)
    a2 = np.load(adj2_path)
    return duplex_from_layers(a1.shape[0], edges_from_dense_adj(a1),
                              edges_from_dense_adj(a2), degree_cost=degree_cost,
                              device=device)
