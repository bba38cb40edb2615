"""The benchmark's registry: everything is found by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations,
traffic mixes and metrics.  Each named piece lives in a file of its own
under `portbench/`, so a later change adds a cell, a configuration, a
traffic mix, a query template or a per-layer metric by adding files and
entries, never by editing a file that is already here:

    configs/<config>.json        sizes, guarantees, deployment kind
    deploy/<kind>.py             brings a deployment up (class Deployment)
    traffic/<traffic>.json       loop kind, clients, the order of templates
    queries/<template>.json      SQL, qgen ranges, validation parameters,
                                 the name of its reference
    reference/<reference>.py     plain reference of one template
    metrics/<metric>.py          reader of one per-layer metric (read())
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, List, Optional

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _check_name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    return name


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import one file by path under a private module name (file names
    may hold dots, which `import` cannot spell)."""
    mod_name = "portbench_dyn_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, doc: dict, root: str = ROOT, pkg: str = PKG):
        self.doc = doc
        self.root = root
        self.pkg = pkg

    @classmethod
    def load(cls, root: str = ROOT, pkg: str = PKG) -> "Spec":
        return cls(_read_json(os.path.join(root, "BENCHMARK.json")), root, pkg)

    # -- entries of BENCHMARK.json -------------------------------------
    def cell(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config_entry(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.doc["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    # -- files found by name ---------------------------------------------
    def config(self, name: str) -> dict:
        path = os.path.join(self.root, self.config_entry(name)["file"])
        return _read_json(path)

    def traffic(self, name: str) -> dict:
        _check_name("traffic", name)
        return _read_json(os.path.join(self.pkg, "traffic", name + ".json"))

    def query(self, name: str) -> dict:
        _check_name("query template", name)
        return _read_json(os.path.join(self.pkg, "queries", name + ".json"))

    def deploy(self, kind: str):
        _check_name("deployment kind", kind)
        return load_module(os.path.join(self.pkg, "deploy", kind + ".py"),
                           "deploy_" + kind)

    def reference(self, name: str):
        _check_name("reference", name)
        return load_module(os.path.join(self.pkg, "reference", name + ".py"),
                           "reference_" + name)

    def metric_reader(self, name: str):
        _check_name("metric", name)
        return load_module(os.path.join(self.pkg, "metrics", name + ".py"),
                           "metric_" + name)


def metric_entry(spec: Spec, name: str) -> Optional[dict]:
    for m in spec.doc["end_to_end"] + spec.doc["per_layer"]:
        if m["name"] == name:
            return m
    return None
