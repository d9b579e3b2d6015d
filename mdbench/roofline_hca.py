"""The least time of HCA-Dismantler's forward and of its band launches, at
the published peaks of roofline.py, from the band's shapes and the run's
counts.

Band launches: each band_spmm launch (the node pooling, K1 at width D) and
each band_spmm_comm launch (the community pass, K1 on the one-hot
membership, at its chunk's width) bound by roofline.pass_ms.  The forward's
least work a call, over both layers: the node pooling's band passes; the
community graph at its least form, two operations a live edge; the
community sums, the node rows read and the community rows written once a
round; and the dense products over the node rows (input, the rounds' two
D×D products, the fusion's D×D and logistic columns, the decoder's 2D
column) and the community rows (the rounds' products, the macro GCN's
W_macro, the fusion, the score).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from mdbench.roofline import PEAK_BYTES_S, PEAK_F32_S, _mm_ms, pass_ms


def _per_layer(bands, D: int) -> float:
    return sum(pass_ms(b, D, False) for b in bands) / len(bands)


def band_launches_ms(bands, counts: Dict[str, int], comm_widths: List[int], calls: int,
                     D: int = 64) -> Optional[float]:
    """Least ms of the stretch's band launches; None where a launched kind
    is neither, or the community launches are not whole passes (two layers
    a call, a launch a chunk of comm_widths)."""
    total = 0.0
    for name, c in counts.items():
        if not c:
            continue
        if name == "band_spmm":
            total += c * _per_layer(bands, D)
        elif name == "band_spmm_comm":
            if c != 2 * calls * len(comm_widths):
                return None
            total += 2 * calls * sum(_per_layer(bands, w) for w in comm_widths)
        else:
            return None
    return total


def forward_ms(bands, n: int, c_pad: int, live_edges: int, D: int = 64, rounds: int = 3,
               F: int = 3) -> float:
    """Least ms of one HCA forward (both layers)."""
    band = sum(rounds * pass_ms(b, D, False) for b in bands)
    comm_graph = 1e3 * 2.0 * live_edges / PEAK_F32_S
    comm_sums = 2 * rounds * 1e3 * 4.0 * (n + c_pad) * D / PEAK_BYTES_S
    node_rows = (_mm_ms(n, F, D) + rounds * 2 * _mm_ms(n, D, D) + _mm_ms(n, D, D)
                 + 2 * _mm_ms(n, D, 1) + _mm_ms(n, 2 * D, 1))
    comm_rows = (rounds * 2 * _mm_ms(c_pad, D, D) + _mm_ms(c_pad, D, D) + _mm_ms(c_pad, D, D)
                 + 2 * _mm_ms(c_pad, D, 1) + _mm_ms(c_pad, 2 * D, 1))
    return band + comm_graph + comm_sums + 2 * (node_rows + comm_rows)
