"""Find a cell's files by name.

A cell `<cell>` is `workloads/<cell>.json`; it names its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<traffic>.json`)
and the per-layer metrics it reports, each a reader
`metrics/<metric>.py`. Nothing here knows a particular cell: a later
change adds a configuration, a mix, a cell or a metric as new files.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
END_TO_END = ("setup_s", "solve_s", "solve_p90_s", "peak_device_GB")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name) or ".." in name:
        raise ValueError(f"{what} name {name!r} is not a name")
    return name


def _load_json(root: Path, folder: str, name: str, what: str) -> dict:
    path = root / folder / f"{check_name(name, what)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {what} {name!r} ({path})")
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    chips: int
    why: str
    root: Path


def load_cell(name: str, root: Path | str = ROOT) -> Cell:
    """The cell `name` with its configuration and traffic mix."""
    root = Path(root)
    w = _load_json(root, "workloads", name, "cell")
    config = _load_json(root, "configs", w["config"], "configuration")
    traffic = _load_json(root, "traffic", w["traffic"], "traffic mix")
    unknown = [m for m in w["end_to_end"] if m not in END_TO_END]
    if unknown:
        raise ValueError(f"cell {name}: unknown end-to-end metrics "
                         f"{unknown}")
    for m in w["per_layer"]:
        check_name(m, "metric")
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=list(w["end_to_end"]),
                per_layer=list(w["per_layer"]), limits=dict(w["limits"]),
                chips=int(w["chips"]), why=w["why"], root=root)


def load_metric(name: str, root: Path | str = ROOT) -> ModuleType:
    """The reader `metrics/<name>.py`: a module with UNIT, BETTER, SOURCE,
    LAYER, MOVES and `read(data) -> float | None`."""
    path = Path(root) / "metrics" / f"{check_name(name, 'metric')}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"eigbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
