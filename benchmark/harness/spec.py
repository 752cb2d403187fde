"""The benchmark's definition and the files it names.

``BENCHMARK.json`` at the root of the checkout names every configuration,
traffic mix, cell and metric; each is found by its name:

* a configuration: the ``file`` its entry gives (``configs/<name>.json``);
* a traffic mix: ``traffic/<name>.json``, whose ``driver`` names the
  general driver (``drivers/<driver>.py``) that reads it;
* a per-layer metric: ``metrics/<name>.py``, whose ``read(run)`` returns
  its value or None;
* a cell's correctness limits: ``limits/<cell>.json``.

So a later change adds a configuration, a mix, a cell or a metric by adding
files and entries, without editing any file here.
"""

import importlib.util
import json
import os
from typing import List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` (``root``: the checkout; ``bench_dir``: where
    ``configs/``, ``traffic/``, ``metrics/`` and ``limits/`` lie)."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR,
                 path: Optional[str] = None):
        self.root, self.bench_dir = root, bench_dir
        self.data = load_json(path or os.path.join(root, "BENCHMARK.json"))

    def _by_name(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._by_name("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._by_name("configs", name)
        return load_json(os.path.join(self.root, entry["file"]))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "traffic",
                                      name + ".json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.bench_dir, "limits",
                                      cell + ".json"))

    def end_to_end(self, cell: str) -> List[dict]:
        """The cell's end-to-end metrics: those without ``workloads`` and
        those that list it."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those without ``workloads`` whose ``moves`` the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    def check_cell(self, cell: str) -> None:
        """Refuse a cell that reports a per-layer metric without the
        end-to-end metric it moves, or that lacks ``setup_s``, another
        end-to-end metric or a per-layer metric."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        for m in self.per_layer(cell):
            if m["moves"] not in e2e:
                raise ValueError(
                    f"cell {cell!r} reports {m['name']!r}, which moves "
                    f"{m['moves']!r}, but does not report {m['moves']!r}")
        if "setup_s" not in e2e or len(e2e) < 2:
            raise ValueError(f"cell {cell!r} needs setup_s and another "
                             f"end-to-end metric, has {sorted(e2e)}")
        if not self.per_layer(cell):
            raise ValueError(f"cell {cell!r} reports no per-layer metric")

    def reader(self, metric: str):
        """``metrics/<metric>.py``'s ``read``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        mod_name = "bench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def driver(name: str):
    """``drivers/<name>.py`` as a module."""
    return importlib.import_module(f"benchmark.drivers.{name}")
