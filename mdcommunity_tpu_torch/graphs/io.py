"""Graph I/O: real multiplex `.edges` files.

Format (the reference's MultiDismantler_torch.read_multiplex :602-635):
whitespace rows `layer_id u v [w]`, node ids 1-based, self-loops skipped.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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
