"""set-up (read under the host env layer): the host seconds of both
layers' Louvain partitions, the program's louvain_s (graphs/louvain.py's
louvain_labels, through hca_communities_and_features(stats=...))."""


def read(layer):
    s = layer.get("louvain_s")
    return float(sum(s)) if s else None
