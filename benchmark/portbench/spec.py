"""Finding a cell's parts by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
each metric.  Everything that belongs to one of them is a file of its own
under the benchmark's directory (``home``):

* ``configs/<config>.json`` — the configuration, as ``BENCHMARK.json``'s
  ``file`` names it; its ``driver`` key names the driver;
* ``traffic/<traffic>.json`` — the traffic mix's parameters;
* ``drivers/<driver>.py`` — the code that drives one kind of entry point;
* ``metrics/<metric>.py`` — one reader per metric, end to end or per layer.

So a later cell, mix, driver kind or metric is new files and new entries,
and no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object        # the driver module
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


class Bench:
    """The benchmark of ``root/BENCHMARK.json``, whose files lie under
    ``home``."""

    def __init__(self, root: Path, home: Path):
        self.root, self.home = Path(root), Path(home)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        if str(self.home) not in sys.path:
            sys.path.insert(0, str(self.home))

    def _module(self, kind: str, name: str):
        path = self.home / kind / f"{name}.py"
        if not path.is_file():
            raise LookupError(f"no {kind[:-1]} file {path}")
        mod_name = f"portbench_{kind}__{name.replace('.', '__')}"
        if mod_name in sys.modules:
            return sys.modules[mod_name]
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod

    def metric(self, name: str):
        """The reader module of metric ``name``: ``read(ctx)`` returns its
        value, or None when the run gave it nothing to read."""
        return self._module("metrics", name)

    def workload_names(self) -> list[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def cell(self, name: str) -> Cell:
        work = next((w for w in self.spec["workloads"] if w["name"] == name),
                    None)
        if work is None:
            raise LookupError(f"no workload {name!r} in BENCHMARK.json; "
                              f"there are {self.workload_names()}")
        conf = next(c for c in self.spec["configs"]
                    if c["name"] == work["config"])
        config = json.loads((self.root / conf["file"]).read_text())
        traffic_file = self.home / "traffic" / f"{work['traffic']}.json"
        if not traffic_file.is_file():
            raise LookupError(f"no traffic file {traffic_file}")
        traffic = json.loads(traffic_file.read_text())

        # A metric without ``workloads``: an end-to-end one is every
        # cell's, a per-layer one that of every cell reporting what it
        # moves.
        end_to_end = [m for m in self.spec["end_to_end"]
                      if name in m.get("workloads", [name])]
        reported = {m["name"] for m in end_to_end}
        per_layer = [m for m in self.spec["per_layer"]
                     if (name in m["workloads"] if "workloads" in m
                         else m["moves"] in reported)]
        return Cell(name=name, chips=int(work["chips"]), config=config,
                    traffic=traffic,
                    driver=self._module("drivers", config["driver"]),
                    end_to_end=end_to_end, per_layer=per_layer)
