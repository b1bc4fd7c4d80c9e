"""Finds everything of a cell by name: the manifest ``BENCHMARK.json`` at
the checkout's root, ``configs/<config>.json``, ``traffic/<mix>.json``
(whose ``kind`` names the module ``kinds/<kind>.py``),
``limits/<cell>.json`` and one reader a per-layer metric,
``metrics/<metric>.py``. A new cell, configuration, traffic mix or metric
is new files plus entries in the manifest; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_.-")


def check_name(name: str) -> str:
    """A file-system-safe name, as the manifest's rules allow."""
    if not name or len(name) > 64 or set(name) - NAME_CHARS or name[0] in ".-":
        raise ValueError(f"bad name {name!r}")
    return name


class Registry:
    def __init__(self, manifest: Optional[Path] = None):
        self.manifest_path = manifest or PACKAGE_DIR.parent / "BENCHMARK.json"
        with open(self.manifest_path) as f:
            self.manifest = json.load(f)

    def cell(self, workload: str) -> dict:
        for cell in self.manifest["workloads"]:
            if cell["name"] == workload:
                return cell
        raise KeyError(f"no workload {workload!r} in {self.manifest_path}")

    def config(self, name: str) -> dict:
        entry = next((c for c in self.manifest["configs"] if c["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no config {name!r} in the manifest")
        return _json(PACKAGE_DIR.parent / entry["file"])

    @staticmethod
    def traffic(name: str) -> dict:
        return _json(PACKAGE_DIR / "traffic" / f"{check_name(name)}.json")

    @staticmethod
    def limits(workload: str) -> Dict[str, float]:
        return _json(PACKAGE_DIR / "limits" / f"{check_name(workload)}.json")

    @staticmethod
    def kind(name: str) -> ModuleType:
        return importlib.import_module(f"portbench.kinds.{check_name(name)}")

    def end_to_end(self, workload: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.manifest["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.manifest["per_layer"]
                if workload in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in e2e)]

    @staticmethod
    def reader(metric: str) -> ModuleType:
        """``metrics/<metric>.py``, loaded by path (a metric's name may
        hold dots)."""
        path = PACKAGE_DIR / "metrics" / f"{check_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}",
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
