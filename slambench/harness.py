"""The benchmark's machinery, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds each by its name under ``slambench/``:

* ``configs/<config>.json``: the ``SlamConfig`` fields, the session's
  attributes (``session``) and where they come from;
* ``traffic/<traffic>.json``: the world, the lap, the odometry, the route
  that offers the frames (``route``) and how the run is checked
  (``check``) and traced (``trace_frames``);
* ``routes/<route>.py``: how frames reach the program (a ``Route`` class);
* ``metrics/<metric>.py``: one ``read(trace, cell)`` per per-layer metric;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.

Adding any of these is adding a file: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "cv_monoslam_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def find(kind: str, name: str, ext: str, base: str = HERE) -> str:
    """The file of ``name`` under ``<base>/<kind>/``."""
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" file {path}")
    return path


def load_module(path: str) -> ModuleType:
    """A module from a file whose name may hold dots."""
    name = "slambench_" + os.path.relpath(path, HERE).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name: str, base: str = HERE) -> dict:
    return load_json(find("configs", name, ".json", base))


def traffic(name: str, base: str = HERE) -> dict:
    return load_json(find("traffic", name, ".json", base))


def route(name: str, base: str = HERE) -> ModuleType:
    return load_module(find("routes", name, ".py", base))


def metric(name: str, base: str = HERE) -> ModuleType:
    return load_module(find("metrics", name, ".py", base))


def limits(cell_name: str, base: str = HERE) -> dict:
    return load_json(find("limits", cell_name, ".json", base))["limits"]


def cell_metrics(bench: dict, cell_name: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    the cell reports: those listing it, or listing no cells."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", [cell_name])]


def forbidden_modules(modules: Optional[dict] = None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules}
                  & set(FORBIDDEN))
