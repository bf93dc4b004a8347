"""What a cell is made of, found by name from ``BENCHMARK.json``.

A configuration is the JSON file its entry names; the path its cells drive
is ``paths/<path>.py``, named by the configuration's ``path`` (``convert_batch``
where it names none); a traffic mix is ``traffic/<traffic>.json``; a metric
is ``metrics/<metric>.py``, whose ``read(run)`` returns a number or None. A
new cell, configuration, path, traffic mix or metric is therefore new files
and new entries, never an edit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from collections.abc import Callable
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
DEFAULT_PATH = "convert_batch"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, its entry's name and source added
    traffic: dict
    metrics: list[dict]  # the BENCHMARK.json entries this cell reports, in order


def applies(metric: dict, cell: str, end_to_end: dict[str, dict]) -> bool:
    """A metric with ``workloads`` is reported in those cells; a per-layer
    metric without them, wherever the metric it moves is; an end-to-end one
    without them, everywhere."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or applies(end_to_end[moves], cell, end_to_end)


def load_cell(root: Path, name: str, traced: bool) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf_entry["file"]).read_text())
    config.update(name=conf_entry["name"], source=conf_entry["source"])
    traffic = json.loads((BENCH_DIR / "traffic" / f"{entry['traffic']}.json").read_text())
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    group = bench["per_layer"] if traced else bench["end_to_end"]
    metrics = [m for m in group if applies(m, name, e2e)]
    return Cell(name, entry["chips"], config, traffic, metrics)


def _load(kind: str, name: str) -> ModuleType:
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def reader(metric: str) -> Callable[[object], float | None]:
    """``read`` of ``metrics/<metric>.py``."""
    return _load("metrics", metric).read


def path(config: dict) -> ModuleType:
    """``paths/<path>.py`` of the configuration's ``path``: the program's
    set-up, the timed call, its wrappers, reference, judge and yardstick
    (run.py names what a path module gives)."""
    return _load("paths", config.get("path", DEFAULT_PATH))
