"""What a cell is made of, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration is ``configs/<name>.json``, the traffic ``traffic/<name>.
json``, the limits of the comparison that decides ``correct``
``checks/<workload>.json``, and each per-layer metric a reader
``metrics/<name>.py``. Adding a cell, a scene, a mix or a metric adds
files and entries; no file here needs an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; raises KeyError
    for a name it does not have."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "checks" / f"{workload}.json").read_text())
    mine = lambda m: workload in m.get("workloads", [workload])
    return Cell(workload=workload, config=config, traffic=traffic,
                limits=limits["limits"],
                end_to_end=[m for m in spec["end_to_end"] if mine(m)],
                per_layer=[m for m in spec["per_layer"] if mine(m)])


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
