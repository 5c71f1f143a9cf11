"""Find a part of the benchmark by its name.

A family of programs (``programs/<family>.py``), a model's reference
(``reference/models/<model>.py``), a kind of traffic
(``traffic/kinds/<kind>.py``), a loop that offers it
(``traffic/loops/<loop>.py``) and a per-layer metric's reader
(``metrics/<metric>.py``) are each a file of their own, loaded by path from
the name that a configuration, a traffic mix or ``BENCHMARK.json`` gives.
A later cell adds such a file and edits none.  An unknown name raises: no
part stands in for another.
"""
from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@functools.lru_cache(maxsize=None)
def load(folder: str, name: str) -> ModuleType:
    """``bench/<folder>/<name>.py`` as a module."""
    path = BENCH / folder / f"{name}.py"
    if not NAME.match(name) or not path.is_file():
        raise LookupError(f"unknown {folder} {name!r}: no bench/{folder}/"
                          f"{name}.py")
    tag = re.sub(r"\W", "_", f"bench_{folder}_{name}")
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(folder: str) -> tuple:
    """The names that ``folder`` holds a file for."""
    return tuple(sorted(p.stem for p in (BENCH / folder).glob("*.py")
                        if NAME.match(p.stem) and p.stem != "__init__"))
