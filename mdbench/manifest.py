"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix; each lives in files of its
own: configs/<config>.json (sizes and checkpoint; its plain reference beside
it as configs/<config>.py), traffic/<traffic>.json (parameters of the
generator and of the kind of run), limits/<cell>.json (what `correct`
compares, each number with its limit) and metrics/<metric>.py for each
per-layer metric (a reader: read(layer) -> number or None).  A later cell,
configuration, mix or metric is new files plus entries in BENCHMARK.json.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Manifest:
    def __init__(self, bench: dict, here: str = HERE):
        self.bench = bench
        self.here = here

    @classmethod
    def load(cls, root: str) -> "Manifest":
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(json.load(f))

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, *parts: str) -> dict:
        with open(os.path.join(self.here, *parts)) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(os.path.dirname(self.here), c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", f"{cell}.json")["limits"]

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.bench["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "mdbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def kind(self, traffic: dict):
        return importlib.import_module(f"mdbench.kinds.{traffic['kind']}")

