"""Finds the benchmark's pieces by the names ``BENCHMARK.json`` and the
configuration and traffic files give: a graph generator
``graphs/<name>.py``, a traffic entry ``entries/<name>.py``, a per-layer
metric's reader ``metrics/<name>.py``.  A new piece is a new file."""
from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder}/{name}.py in {HERE}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_name(metric: str, folder: str = "metrics") -> str:
    """The reader a per-layer metric takes: ``metrics/<metric>.py``, or,
    where there is none, that of the name with its last dotted part
    dropped, and so on (``device.idle_pct.select.lt`` reads with
    ``metrics/device.idle_pct.py``: a variant reports the same quantity
    in other cells)."""
    name = metric
    while not (HERE / folder / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader for {metric!r} in {folder}/")
        name = name.rsplit(".", 1)[0]
    return name
