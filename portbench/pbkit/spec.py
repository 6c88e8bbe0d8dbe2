"""Find a cell's pieces by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix.  The
configuration's file is the one ``configs`` gives it; the traffic mix is
``traffic/<traffic>.json``; the configuration names its driver,
``drivers/<driver>.py``; each per-layer metric is ``layers/<metric>.py``
and each roofline's work function ``roofline/<op>.py``.  Nothing here
knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """Import the Python file ``path`` as module ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: str

    def driver(self):
        drv = self.config["driver"]
        return load_module(os.path.join(HERE, "drivers", f"{drv}.py"),
                           f"portbench_driver_{drv}")

    def layer(self, metric: str):
        return load_module(os.path.join(HERE, "layers", f"{metric}.py"),
                           f"portbench_layer_{metric}")


def roofline(op: str):
    return load_module(os.path.join(HERE, "roofline", f"{op}.py"),
                       f"portbench_roofline_{op}")


def load_cell(workload: str, bench_path: str | None = None) -> Cell:
    root = ROOT if bench_path is None else os.path.dirname(
        os.path.abspath(bench_path))
    bench = load_json(bench_path or os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    return Cell(workload=w, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)],
                root=root)
