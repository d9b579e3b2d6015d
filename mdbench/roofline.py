"""The yardstick's arithmetic: the card's published peaks, the least time of
one band-operator pass, and the least time of the model's work.

`pass_ms` is a frozen copy of chip_smoke.py's `bounds` (whose byte count
is mdcommunity_tpu_torch/utils/timing.py's `band_pass_bytes` plus the
slot map's read), taking the band's shapes as numbers.  Each input is read
once and the output written once, over the memory rate; the operations are
one multiply-add per band nonzero and column at the band's rate, K2's two
D×D products at the epilogue's rate, and the mirror add and the row scale
(K2: also the normalisation) at the FP32 rate.  The least time is the larger
of the two.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


@dataclasses.dataclass(frozen=True)
class Band:
    """One layer's band operator as numbers: blocks, rows a block, mirror
    lanes, padded rows, window width, stored band nonzeros, nibble
    storage."""

    n_blocks: int
    S: int
    C: int
    pad_n: int
    W2: int
    nnz: int
    nibble: bool = False


def pass_ms(b: Band, D: int, sage: bool, store_bytes: int = 4,
            band_rate: float = PEAK_F32_S, epi_rate: float = PEAK_F32_S) -> float:
    """Least ms of one band pass (K1, or K2 with sage) at width D."""
    nb, S, C, pad_n = b.n_blocks, b.S, b.C, b.pad_n
    base_w = b.W2 // 2 if b.nibble else b.W2
    byts = (nb * S * base_w + 2 * pad_n * D * store_bytes + 2 * pad_n * 4
            + nb * C * D * 4 + nb * S * 4)
    f32_ops, epi_ops = 2 * pad_n * D, 0
    if sage:
        byts += 2 * D * D * 4
        f32_ops += 3 * pad_n * D
        epi_ops = 2 * 2 * pad_n * D * D
    t_b = byts / PEAK_BYTES_S
    t_o = 2 * b.nnz * D / band_rate + epi_ops / epi_rate + f32_ops / PEAK_F32_S
    return 1e3 * max(t_b, t_o)


# the band kernels' launch counters (ops/band_kernels.launches) this
# benchmark can bound: name -> (sage, store bytes, band rate, epilogue rate)
_KINDS = {
    "band_spmm": (False, 4, PEAK_F32_S, PEAK_F32_S),
    "band_spmm_bwd": (False, 4, PEAK_F32_S, PEAK_F32_S),
    "band_sage": (True, 4, PEAK_F32_S, PEAK_F32_S),
}


def launches_ms(bands, counts: Dict[str, int], d2_launches: int, D: int = 64) -> Optional[float]:
    """Least ms of the band launches `counts` (counter name -> launches,
    over both layers, whose bands are `bands`, taken as alike: the mean of
    the two layers' bounds), of which `d2_launches` of band_spmm are the
    degree passes at width 2.  None when a launched kind is one this file
    cannot bound (K3, the community pass, the diag variants, the bf16
    modes: a cell that launches them brings a reader with their rates)."""
    total = 0.0
    for name, c in counts.items():
        if not c:
            continue
        nib = name.endswith("_nib")
        kind = name[:-4] if nib else name
        if kind not in _KINDS:
            return None
        sage, store, rate, epi = _KINDS[kind]
        per = [dataclasses.replace(b, nibble=b.nibble or nib) for b in bands]
        if kind == "band_spmm":
            d2 = min(d2_launches, c)
            total += d2 * sum(pass_ms(b, 2, False) for b in per) / len(per)
            c -= d2
        total += c * sum(pass_ms(b, D, sage, store, rate, epi) for b in per) / len(per)
    return total


def _mm_ms(m: int, k: int, n: int, rate: float = PEAK_F32_S) -> float:
    """Least ms of an [m, k] @ [k, n] f32 product."""
    return 1e3 * max(2.0 * m * k * n / rate, 4.0 * (m * k + k * n + m * n) / PEAK_BYTES_S)


def dense_forward_ms(n: int, D: int = 64, F: int = 2, hidden: int = 32, aux: int = 4,
                     rounds: int = 3, q_rows: int = None) -> float:
    """Least ms of one forward's dense products over n node rows: per layer
    the input layer, each round's two D×D products (the concat-matmul
    algebra's least form), the fusion's D×D and its two logistic columns,
    and the Q head over q_rows rows (all n by default)."""
    q_rows = n if q_rows is None else q_rows
    per_layer = (_mm_ms(n, F, D) + rounds * 2 * _mm_ms(n, D, D) + _mm_ms(n, D, D)
                 + 2 * _mm_ms(n, D, 1) + _mm_ms(q_rows, D, hidden)
                 + _mm_ms(q_rows, hidden + aux, 1))
    return 2 * per_layer


def forward_ms(bands, n: int, D: int = 64, rounds: int = 3) -> float:
    """Least ms of one Q forward: two degree passes at width 2, 3 rounds of
    a K1 pass a layer at width D, and the dense products."""
    band = sum(pass_ms(b, 2, False) + rounds * pass_ms(b, D, False) for b in bands)
    return band + dense_forward_ms(n, D, rounds=rounds)


def fit_ms(bands, n: int, k: int, D: int = 64, rounds: int = 3) -> float:
    """Least ms of one fit on k actions: the inputs' degree passes, the
    embedding's forward, the regulariser's pass a layer, the backward of
    every band pass, and the dense products forward and twice backward
    (dX, dW), the Q head on the k action rows."""
    band = sum(pass_ms(b, 2, False) + 2 * (rounds + 1) * pass_ms(b, D, False)
               for b in bands)
    return band + 3 * dense_forward_ms(n, D, rounds=rounds, q_rows=k)
