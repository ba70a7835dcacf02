"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix; the traffic file names its
loop, ``loops/<loop>.py`` (a class ``Loop``), and its content,
``content/<content>.py`` (a function ``generate``).  A per-layer metric is
read by ``layer_metrics/<name>.py`` or, failing that, by the reader of its
stem (the part before the first dot), which is handed the rest as its
``part``; a kernel's bytes come from ``roofline/<symbol>.py``.  Adding any
of these means adding a file and an entry, never editing one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    metrics resolved."""

    def __init__(self, bench: dict, name: str, root: str = ROOT) -> None:
        self.root = root
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        self.name = name
        self.workload = cells[name]
        self.chips = self.workload["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = _load_json(os.path.join(root, entry["file"]))
        self.traffic = _load_json(
            os.path.join(root, "perfbench", "traffic", self.workload["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._here(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._here(m)]

    def _here(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])


def _module(path: str):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(folder: str, name: str, attr: str, root: str):
    path = os.path.join(root, "perfbench", folder, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder}/{name}.py under {root}/perfbench")
    return getattr(_module(path), attr)


@functools.lru_cache(maxsize=None)
def loop_class(name: str, root: str = ROOT):
    """The ``Loop`` class of ``loops/<name>.py``."""
    return _named("loops", name, "Loop", root)


@functools.lru_cache(maxsize=None)
def generator(name: str, root: str = ROOT):
    """``generate(frames, height, width, seed, device)`` of ``content/<name>.py``."""
    return _named("content", name, "generate", root)


@functools.lru_cache(maxsize=None)
def layer_reader(name: str):
    """(read function, part) for a per-layer metric: read(run, part)."""
    stem, _, rest = name.partition(".")
    for fname, part in ((name, None), (stem, rest or None)):
        path = os.path.join(HERE, "layer_metrics", fname + ".py")
        if os.path.exists(path):
            return _module(path).read, part
    raise FileNotFoundError(f"no reader for per-layer metric {name!r} in layer_metrics/")


@functools.lru_cache(maxsize=None)
def kernel_bytes(symbol: str):
    """essential_bytes(facts) of a port kernel, or None without a file."""
    path = os.path.join(HERE, "roofline", symbol + ".py")
    return _module(path).essential_bytes if os.path.exists(path) else None


@functools.lru_cache(maxsize=None)
def peaks() -> dict:
    return _load_json(os.path.join(HERE, "roofline", "peaks.json"))
