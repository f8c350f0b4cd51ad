"""Small sizes of the cells for the CPU tests: the files' cells and
configurations with sizes cut, run through the harness on the CPU, where
the int8 blocks run their plain versions."""

import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

SMALL_CFG = {"fineSize": 64, "ngf": 8, "ndf": 8, "n_blocks_global": 1,
             "n_downsample_global": 2}
SMALL_PARAMS = {"batch": 2, "ring_frames": 4, "ring_pairs": 4,
                "sample_calls": 2, "warmup_calls": 1, "trace_seconds": 0.3,
                "compute_dtype": "float32"}


def small(name: str, **cfg_over):
    """The cell's file and configuration at small sizes, fp32 compute."""
    cell, cfg = harness.cell_files(name)
    cell, cfg = copy.deepcopy(cell), dict(cfg)
    if cfg["netG"] == "UNet":      # three downs whatever the option says
        cfg.update({k: v for k, v in SMALL_CFG.items()
                    if k != "n_downsample_global"})
    else:
        cfg.update(SMALL_CFG)
    cfg.update(cfg_over)
    cell["params"].update({k: v for k, v in SMALL_PARAMS.items()
                           if k in cell["params"]})
    return cell, cfg


def run(name: str, seed: int = 7, seconds: float = 0.3, trace: bool = False,
        **cfg_over):
    import torch
    cell, cfg = small(name, **cfg_over)
    return harness.run_cell(name, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), cell, cfg)


def ctx(name: str, seed: int, cell=None, cfg=None):
    import torch
    fcell, fcfg = harness.cell_files(name)
    return harness.Ctx(cell or fcell, cfg or fcfg, seed, 0.0, False,
                       torch.device("cpu"), time.perf_counter())
