"""Where the harness finds each piece, by the name ``BENCHMARK.json`` or a
traffic file gives it.  Nothing here lists a cell, a configuration, a loop
or a metric: a later change adds one as a new file.

* a configuration: ``portbench/configs/<config>.json``;
* a traffic mix: ``portbench/workloads/<cell>.json``, which names its
  configuration and its traffic loop;
* a traffic loop: ``portbench/loops/<loop>.py``;
* a metric's reader: ``portbench/metrics/<metric>.py`` (``read(run)``); a
  quantity split by the end-to-end metric it moves (``<metric>.<part>``)
  is read by ``<metric>.py`` unless ``<metric>.<part>.py`` exists;
* a call's bytes: ``portbench/roofline/<call>.py`` (``bytes_per_item``).
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _name(kind: str, name: str) -> str:
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


class Bench:
    """The benchmark rooted at a checkout ``root`` (the directory holding
    ``BENCHMARK.json`` and ``portbench/``)."""

    def __init__(self, root):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        manifest = self.root / "BENCHMARK.json"
        self.manifest = json.loads(manifest.read_text()) if manifest.is_file() else {}

    def _json(self, kind: str, folder: str, name: str) -> dict:
        path = self.dir / folder / f"{_name(kind, name)}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
        return json.loads(path.read_text())

    def _module(self, kind: str, folder: str, name: str):
        path = self.dir / folder / f"{_name(kind, name)}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
        tag = re.sub(r"\W", "_", f"portbench_{folder}_{name}")
        spec = importlib.util.spec_from_file_location(tag, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def workload(self, cell: str) -> dict:
        return self._json("workload", "workloads", cell)

    def config(self, name: str) -> dict:
        return self._json("configuration", "configs", name)

    def loop(self, name: str):
        return self._module("loop", "loops", name)

    def reader(self, metric: str):
        base = metric.split(".")[0]
        if base != metric and not (self.dir / "metrics" / f"{_name('metric', metric)}.py").is_file():
            metric = base
        return self._module("metric", "metrics", metric)

    def roofline(self, call: str):
        return self._module("roofline", "roofline", call)

    def peaks(self) -> dict:
        return json.loads((self.dir / "roofline" / "peaks.json").read_text())

    def chips(self, cell: str) -> int:
        for entry in self.manifest.get("workloads", []):
            if entry["name"] == cell:
                return int(entry["chips"])
        raise KeyError(f"BENCHMARK.json has no cell {cell!r}")

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with tracing the per-layer ones, each that lists the cell (an
        end-to-end metric with no list goes with every cell)."""
        if traced:
            return [m for m in self.manifest.get("per_layer", []) if cell in m["workloads"]]
        return [m for m in self.manifest.get("end_to_end", []) if cell in m.get("workloads", [cell])]
