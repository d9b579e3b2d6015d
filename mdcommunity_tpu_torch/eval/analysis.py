"""Comparison report: join unit-cost and community results into one CSV
(reference: code/analysis_comparison.py, which joins time&audc_*.csv pairs
into results/final_comparison_report.csv with per-dataset deltas).

The JAX package builds the report with pandas (read_csv, an outer join on
the dataset, two delta columns, to_csv).  The card's machine has no pandas,
so this module repeats what those calls do with the csv module, and writes
the same bytes:

  * reading: the first row names the columns (stripped and lower-cased); a
    file without a "dataset" column has its columns renamed dataset, time,
    audc, and its first row stays lost as the header, as pandas loses it;
    a column whose values are all integers stays integer, one with a
    missing value (an empty field, "NA", "nan", ...) or a decimal is float,
    any other column text;
  * the outer join: the datasets sorted (numeric names before the others),
    a dataset on one side only gets empty fields on the other, a dataset
    repeated on a side joins every row of the other side's with it; the
    shared columns take the suffixes _unit and _community, and integer
    columns that gain a missing value become float;
  * the deltas (community - unit) / unit · 100 in float64: division by 0
    gives inf (or nan for 0 / 0), and nan is written as an empty field;
  * floats written as Python's shortest repr (pandas writes numpy's, the
    same digits), integers as integers.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Tuple

_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?\Z|[+-]?(inf|infinity)\Z", re.I)

Table = Tuple[List[str], List[List[object]]]


def _typed(column: List[str]) -> List[object]:
    """A column's cells as pandas' parser types them: all integers -> int,
    numbers with a decimal or a missing cell -> float (nan where missing),
    else text (None where missing)."""
    present = [x for x in column if x not in _NA]
    if len(present) == len(column) and all(_INT.match(x) for x in present):
        return [int(x) for x in column]
    if all(_INT.match(x) or _FLOAT.match(x) for x in present):
        return [math.nan if x in _NA else float(x) for x in column]
    return [None if x in _NA else x for x in column]


def _read_csv(path: str) -> Table:
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"no columns to parse from {path}")
    header, body = rows[0], rows[1:]
    names = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
    for r in body:
        if len(r) > len(names):
            raise ValueError(f"{path}: a row has {len(r)} fields, the header {len(names)}")
    cols = [_typed([r[i] if i < len(r) else "" for r in body]) for i in range(len(names))]
    return names, [list(r) for r in zip(*cols)] if body else []


def _read_time_audc(path_or_dir: str) -> Table:
    """A time&audc CSV, or the first (by name) such file in a directory."""
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        cands = [f for f in os.listdir(path_or_dir) if f.startswith("time&audc")]
        if not cands:
            raise FileNotFoundError(f"no time&audc_*.csv under {path_or_dir}")
        path = os.path.join(path_or_dir, sorted(cands)[0])
    names, rows = _read_csv(path)
    names = [c.strip().lower() for c in names]
    if "dataset" not in names:
        fallback = ["dataset", "time", "audc"]
        if len(names) > len(fallback):
            raise ValueError(f"{path}: {len(names)} columns and no 'dataset' column")
        names = fallback[: len(names)]
    return names, rows


def _is_missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def _delta_pct(new, old) -> float:
    """(new - old) / old · 100 with numpy's float64 semantics."""
    if _is_missing(new) or _is_missing(old):
        return math.nan
    if isinstance(new, str) or isinstance(old, str):
        raise TypeError(f"cannot subtract {old!r} from {new!r}")
    num = float(new - old) if isinstance(new, int) and isinstance(old, int) \
        else float(new) - float(old)
    den = float(old)
    if den == 0.0:
        if num == 0.0 or math.isnan(num):
            return math.nan
        return math.copysign(math.inf, num) * math.copysign(1.0, den)
    return num / den * 100.0


def _cell(x) -> str:
    if _is_missing(x):
        return ""
    return repr(x) if isinstance(x, float) else str(x)


def comparison_report(
    unitcost: str, community: str, output: str = "final_comparison_report.csv"
) -> List[Dict[str, object]]:
    """Join the unit-cost and community time&audc tables on the dataset and
    add audc_delta_pct and time_delta_pct; writes `output` byte for byte as
    the JAX package's pandas version writes it and returns its rows."""
    (na, ra), (nb, rb) = _read_time_audc(unitcost), _read_time_audc(community)
    ka, kb = na.index("dataset"), nb.index("dataset")
    va = [c for i, c in enumerate(na) if i != ka]
    vb = [c for i, c in enumerate(nb) if i != kb]
    shared = set(va) & set(vb)
    names = (["dataset"] + [c + "_unit" if c in shared else c for c in va]
             + [c + "_community" if c in shared else c for c in vb])

    def by_key(rows, k):
        out: Dict[object, List[list]] = {}
        for r in rows:
            out.setdefault(r[k], []).append([x for i, x in enumerate(r) if i != k])
        return out

    ga, gb = by_key(ra, ka), by_key(rb, kb)
    joined = []
    # pandas' safe sort: numbers first, then text
    for key in sorted(set(ga) | set(gb), key=lambda k: (isinstance(k, str), k)):
        for left in ga.get(key, [None]):
            for right in gb.get(key, [None]):
                joined.append([key] + (left or [None] * len(va)) + (right or [None] * len(vb)))
    # an integer column that gained a missing cell in the join becomes float
    for j in range(1, len(names)):
        col = [r[j] for r in joined]
        if any(x is None for x in col) and all(x is None or isinstance(x, (int, float))
                                               for x in col):
            for r in joined:
                r[j] = math.nan if r[j] is None else float(r[j])

    col = {c: i for i, c in enumerate(names)}
    for metric in ("audc", "time"):
        new, old = col[f"{metric}_community"], col[f"{metric}_unit"]
        for r in joined:
            r.append(_delta_pct(r[new], r[old]))
    names += ["audc_delta_pct", "time_delta_pct"]

    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    with open(output, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for r in joined:
            w.writerow([_cell(x) for x in r])
    return [dict(zip(names, r)) for r in joined]
