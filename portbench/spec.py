"""What ``BENCHMARK.json`` names, found as files under ``portbench/``.

- a cell (``workloads``) pairs ``configs/<file>`` with
  ``traffic/<traffic>.json`` and has its correctness limits in
  ``limits/<cell>.json``;
- a per-layer metric ``<name>`` is read by ``metrics/<name>.py``, whose
  ``read(run)`` returns a number or ``None`` (nothing to read);
- a kernel family ``<name>`` is ``kernels/<name>.json``: the substrings
  of the profiler's kernel names that implement that piece of work;
- a traffic ``kind`` is run by ``drivers/<kind>.py``, and a quantization
  ``format`` is drawn and dequantized by ``formats/<format>.py`` and packed
  for the port by ``pack/<format>.py``;
- a configuration's architecture, its ``model_type``, is drawn, counted
  and run by the reference through ``archs/<model_type>.py`` and built for
  the port by ``build/<model_type>.py``.

A later cell, metric, kernel family, traffic kind, format or architecture
is a new file and a new entry; no file here changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # {number: {"limit": x, ...}}
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str             # the folder holding BENCHMARK.json


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    """Does ``cell`` report ``metric``? A metric with ``workloads`` in the
    cells it lists; an end-to-end metric without it everywhere; a
    per-layer metric without it wherever its ``moves`` metric is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, root: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its files
    (``root`` is the checkout; the files are read from ``<root>/portbench``
    wherever the paths in ``BENCHMARK.json`` put them)."""
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    pb = os.path.join(root, "portbench")
    traffic = _load_json(os.path.join(pb, "traffic", w["traffic"] + ".json"))
    limits = _load_json(os.path.join(pb, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer,
                root)


def metric_reader(name: str, root: str) -> Callable:
    """``read`` of ``<root>/portbench/metrics/<name>.py``, loaded from its
    file (a metric's name may hold dots)."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics._reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_families(root: Optional[str] = None) -> Dict[str, List[str]]:
    """Every kernel family under ``kernels/``."""
    base = os.path.join(os.path.join(root, "portbench") if root else HERE,
                        "kernels")
    return {f[:-5]: _load_json(os.path.join(base, f))["match"]
            for f in sorted(os.listdir(base)) if f.endswith(".json")}
