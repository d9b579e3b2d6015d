"""LMCC-curve comparison plots (reference: drawUnweight.py / drawWeight.py,
overlays of per-method NormalizedLMCC curves per real dataset).

The weighted variant plots x = the cumulative removal cost read from the
cost-curve files (reference MultiDismantler_degree_cost/drawWeight.py:63-68:
`x_values = read_values(cost_file); plt.plot(x_values[:-1], y_values)`; the
cost file's trailing line is the final score and is dropped), not merely a
relabelled node-fraction axis.

matplotlib is imported inside `plot_lmcc_curves` (with the Agg backend), so
the package imports where matplotlib is not installed; there drawing raises
an ImportError that names it.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple, Union

import numpy as np

CurveSpec = Union[str, Tuple[str, str], Sequence[str]]


def read_lmcc_file(path: str) -> np.ndarray:
    """Read a NormalizedLMCC file; the trailing two lines are score mean/std."""
    with open(path) as f:
        vals = [float(x) for x in f.read().split()]
    return np.asarray(vals[:-2] if len(vals) > 2 else vals)


def read_cost_file(path: str) -> np.ndarray:
    """Read a cumulative-cost (Cost_*/cost_*) file; the trailing line is the
    final score and is dropped (reference drawWeight.py:63-65)."""
    with open(path) as f:
        vals = [float(x) for x in f.read().split()]
    return np.asarray(vals[:-1] if len(vals) > 1 else vals)


def _pyplot():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plot_lmcc_curves needs matplotlib, which is not "
                          "installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_lmcc_curves(
    curves: Dict[str, CurveSpec],
    out_path: str,
    title: str = "",
    weighted: bool = False,
):
    """curves: {method label: NormalizedLMCC file path} (unweighted), or
    {label: (cost file path, NormalizedLMCC file path)} when weighted=True.

    The x axis is the removed node fraction (unit cost) or the cumulative
    removal cost read from the cost file (weighted; a bare LMCC path falls
    back to the node fraction)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    for label, spec in curves.items():
        if weighted and not isinstance(spec, str):
            cost_path, lmcc_path = spec
            y = read_lmcc_file(lmcc_path)
            x = read_cost_file(cost_path)
            m = min(len(x), len(y))
            x, y = x[:m], y[:m]
        else:
            path = spec if isinstance(spec, str) else spec[-1]
            y = read_lmcc_file(path)
            x = np.arange(len(y)) / max(len(y) - 1, 1)
        ax.plot(x, y, label=label, linewidth=1.2)
    ax.set_xlabel("removed cost fraction" if weighted else "removed node fraction")
    ax.set_ylabel("normalized LMCC")
    if title:
        ax.set_title(title)
    ax.legend(fontsize=8)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
