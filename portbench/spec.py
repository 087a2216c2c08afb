"""``BENCHMARK.json`` and the data files it names, found by name.

A cell names a configuration and a traffic mix; each metric names a reader.
They live in files of their own, so that a later change adds a cell, a
configuration, a mix or a metric by adding files and entries:

* ``configs/<file>``: a configuration, as ``BENCHMARK.json``'s ``file`` says;
* ``traffic/<name>.json``: a traffic mix (``traffic.py``);
* ``metrics/<name>.py``: a metric's reader, ``read(run) -> float | None``;
* ``limits/<workload>.json``: the limits of a cell's correctness check.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


class Benchmark:
    """``BENCHMARK.json`` at ``root`` and the data files under ``base``."""

    def __init__(self, root: Path, base: Path = HERE):
        self.root, self.base = Path(root), Path(base)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self._readers: Dict[str, Callable] = {}

    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {[w['name'] for w in self.doc['workloads']]}")

    def config_path(self, name: str) -> Path:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return self.root / c["file"]
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.base / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.base / "limits" / f"{workload}.json").read_text())

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.doc[kind] if workload in m.get("workloads", [workload])]

    def reader(self, name: str) -> Callable:
        """``metrics/<name>.py``'s ``read``."""
        if name not in self._readers:
            path = self.base / "metrics" / f"{name}.py"
            mod_name = "portbench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or spec.loader is None:
                raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._readers[name] = mod.read
        return self._readers[name]
