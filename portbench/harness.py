"""One run of one cell: find the cell's file, its configuration and its
traffic module by name, run it, read the per-layer metrics of a traced
run through their own modules, and build the result line.

Everything a cell, a configuration, a traffic mix or a per-layer metric
adds is a file found by its name:
  * ``workloads/<cell>.json``: ``config``, ``traffic``, ``checks`` (each
    compared number's limit) and ``control``;
  * ``configs/<config>.json``: the configuration as it is run;
  * ``traffic/<traffic>.json``: the mix's ``params`` and the ``generator``
    that reads them, ``traffic/<generator>.py`` (``run(ctx) -> Outcome``,
    ``control(ctx)``);
  * ``metrics/<metric>.py``: ``read(record) -> value or None``;
  * ``counts/<config>.py``: the configuration's FLOP counts.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cistar_tpu")


@dataclasses.dataclass
class Ctx:
    """What a traffic module runs: the cell's file, its configuration, the
    run's arguments, the device and the process's start on the host
    clock."""
    cell: Dict[str, Any]
    cfg: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float


@dataclasses.dataclass
class Outcome:
    """What a traffic module hands back: the end-to-end values it measured
    (``setup_s`` among them), the record the per-layer metrics read, each
    compared number with its limit, the device's peak memory, and lines
    for the log (set-up by phase, what the comparison found)."""
    e2e: Dict[str, float]
    record: Dict[str, Any]
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: List[str] = dataclasses.field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> Tuple[dict, dict]:
    """The cell's file, with its traffic mix's ``generator`` and
    ``params``, and its configuration's file."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    cell.update(generator=mix["generator"], params=mix["params"])
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    return cell, cfg


def traffic(cell: dict):
    """The generator module of the cell's traffic mix."""
    return importlib.import_module(f"portbench.traffic.{cell['generator']}")


def counts(cfg: dict):
    return importlib.import_module(f"portbench.counts.{cfg['name']}")


def metric_module(name: str):
    """``metrics/<name>.py`` (a name may hold dots, so loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}",
        HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reported(bench: dict, key: str, cell: str) -> List[dict]:
    """The metrics of ``bench[key]`` this cell reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, cell: Optional[dict] = None,
             cfg: Optional[dict] = None) -> Tuple[dict, Outcome]:
    """Run cell ``name`` and return the result line's object and the
    outcome. ``cell`` / ``cfg`` replace the files' contents (the tests run
    small sizes on the CPU this way)."""
    bench = benchmark()
    fcell, fcfg = cell_files(name)
    cell, cfg = cell or fcell, cfg or fcfg
    ctx = Ctx(cell, cfg, seed, seconds, trace, device, t0)
    out = traffic(cell).run(ctx)
    if trace:
        metrics = {}
        rec = dict(out.record, cell=cell, cfg=cfg, counts=counts(cfg))
        for m in reported(bench, "per_layer", name):
            v = metric_module(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in reported(bench, "end_to_end", name)}
    correct = all(v <= lim for v, lim in out.checks.values())
    dev = device_info(device, out.memory_peak_bytes)
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace:
        tr = out.record["trace"]
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
            result["breakdown"] = {"device_ops": tr["device_ops"],
                                   "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result, out


def device_info(device, memory_peak: int) -> dict:
    import torch
    if getattr(device, "type", str(device)) == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": memory_peak}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": memory_peak}
