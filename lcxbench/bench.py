"""A cell of ``BENCHMARK.json`` and the files it names: its configuration
(``lcxbench/configs/``, by the ``file`` the configuration's entry gives),
its traffic mix (``lcxbench/traffic/<traffic>.json``), the limits of its
correctness check (``lcxbench/limits/<cell>.json``) and the metrics it
reports."""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    def metrics(self, trace: bool) -> List[Dict]:
        return self.per_layer if trace else self.end_to_end


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Dict = None) -> Cell:
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return Cell(
        name=name, chips=int(w["chips"]),
        cfg=load_json(ROOT / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
