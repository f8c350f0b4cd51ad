"""Config tree of the Gatys IST workload (counterpart of
``cistar_tpu/core/config.py``, copied whole: it is pure Python, and the
port imports nothing of the JAX package).

:class:`ConfigNode` is a dependency-free stand-in for the yacs ``CfgNode``
the reference uses (``IST/config/defaults.py:7-104``): dotted access,
freezing, YAML file merge and ``KEY VALUE``-list overrides.
:func:`get_ist_cfg_defaults` gives the Gatys defaults, and
:func:`parse_opt_txt` reads pix2pixHD's ``opt.txt`` snapshots.
"""

from __future__ import annotations

import ast
import copy
import io
import os
import re
from typing import Any, Dict, Iterable, List


class ConfigNode(dict):
    """A dict with attribute access, freeze semantics, and merge helpers.

    A minimal, self-contained re-implementation of the yacs ``CfgNode``
    surface the reference relies on (``clone``, ``freeze``, ``merge_from_file``,
    ``merge_from_list``, dotted attribute access).
    """

    _FROZEN_KEY = "__frozen__"

    def __init__(self, init: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, "_frozen", False)
        if init:
            for k, v in init.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute protocol ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {name!r}")
        self[name] = ConfigNode(value) if isinstance(value, dict) and not isinstance(value, ConfigNode) else value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, "_frozen"):
            raise AttributeError(f"ConfigNode is frozen; cannot set {key!r}")
        super().__setitem__(key, value)

    # -- lifecycle ------------------------------------------------------------
    def clone(self) -> "ConfigNode":
        out = ConfigNode()
        for k, v in self.items():
            out[k] = v.clone() if isinstance(v, ConfigNode) else copy.deepcopy(v)
        return out

    def freeze(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def defrost(self) -> "ConfigNode":
        object.__setattr__(self, "_frozen", False)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()
        return self

    @property
    def is_frozen(self) -> bool:
        return object.__getattribute__(self, "_frozen")

    # -- merging --------------------------------------------------------------
    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str) -> None:
        """Merge a YAML (or simple ``KEY: value``) file into this node."""
        with open(path, "r") as f:
            text = f.read()
        data = _parse_simple_yaml(text)
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        """Merge a flat ``[KEY, VALUE, KEY, VALUE, ...]`` override list."""
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length, got {opts}")
        for key, raw in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _literal(raw)

    # -- serialization ----------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v) for k, v in self.items()
        }

    def dump(self, indent: int = 0) -> str:
        buf = io.StringIO()
        for k in sorted(self.keys()):
            v = self[k]
            pad = " " * indent
            if isinstance(v, ConfigNode):
                buf.write(f"{pad}{k}:\n")
                buf.write(v.dump(indent + 2))
            else:
                buf.write(f"{pad}{k}: {v!r}\n")
        return buf.getvalue()

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.dump())


def _literal(raw: Any) -> Any:
    if not isinstance(raw, str):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Parse an indentation-nested ``KEY: value`` document (YAML subset).

    Avoids a hard pyyaml dependency; full YAML is not needed for our configs.
    """
    root: Dict[str, Any] = {}
    stack: List[tuple[int, Dict[str, Any]]] = [(-1, root)]
    for line in text.splitlines():
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, rest = line.strip().partition(":")
        rest = rest.strip()
        while stack and indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if rest == "":
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _literal(rest)
    return root


# --------------------------------------------------------------------------- #
# IST (Gatys) defaults — parity with reference IST/config/defaults.py:7-104
# --------------------------------------------------------------------------- #
def get_ist_cfg_defaults() -> ConfigNode:
    """Default config for the Gatys IST workload.

    Mirrors the semantics of the reference yacs tree
    (``IST/config/defaults.py``): VGG-19 conv topology, style layers
    relu{1..5}_1, content layer relu4_2, style weights 1e3/n², content weight
    5e-1, 300 LR iterations + 500 HR iterations at 512².
    """
    c = ConfigNode()

    c.MODEL = ConfigNode()
    c.MODEL.META_ARCHITECTURE = "VGG"
    c.MODEL.MODELS_DIR = "./models"
    c.MODEL.WEIGHTS = "./models/vgg_conv.pth"  # torch .pth or converted .npz

    c.MODEL.VGG = ConfigNode()
    # (name, in_channels, out_channels); all convs are 3x3, pad 1.
    c.MODEL.VGG.CONV_LAYERS = [
        ("conv1_1", 3, 64), ("conv1_2", 64, 64),
        ("conv2_1", 64, 128), ("conv2_2", 128, 128),
        ("conv3_1", 128, 256), ("conv3_2", 256, 256),
        ("conv3_3", 256, 256), ("conv3_4", 256, 256),
        ("conv4_1", 256, 512), ("conv4_2", 512, 512),
        ("conv4_3", 512, 512), ("conv4_4", 512, 512),
        ("conv5_1", 512, 512), ("conv5_2", 512, 512),
        ("conv5_3", 512, 512), ("conv5_4", 512, 512),
    ]
    c.MODEL.VGG.FORWARD_SEQ = [
        "conv1_1", "conv1_2", "pool_1",
        "conv2_1", "conv2_2", "pool_2",
        "conv3_1", "conv3_2", "conv3_3", "conv3_4", "pool_3",
        "conv4_1", "conv4_2", "conv4_3", "conv4_4", "pool_4",
        "conv5_1", "conv5_2", "conv5_3", "conv5_4", "pool_5",
    ]

    c.LOSS = ConfigNode()
    c.LOSS.CONTENT_LAYERS = ["relu4_2"]
    c.LOSS.STYLE_LAYERS = ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"]
    c.LOSS.CONTENT_WEIGHTS = [5e-1]
    c.LOSS.STYLE_WEIGHTS = [1e3 / n ** 2 for n in [64, 128, 256, 512, 512]]
    c.LOSS.MAX_ITER = 300
    c.LOSS.LOG_ITER_SHOW = 0.1

    c.HRLOSS = ConfigNode()
    c.HRLOSS.MAX_ITER = 500

    c.DATA = ConfigNode()
    c.DATA.STYLE_IMG_PATH = ""
    c.DATA.CONTENT_IMG_PATH = ""
    c.DATA.IMG_SIZE = 512
    # BGR-order ImageNet mean (Caffe-style VGG preprocessing), as in reference.
    c.DATA.IMAGENET_MEAN = [0.40760392, 0.45795686, 0.48501961]

    c.HRDATA = ConfigNode()
    c.HRDATA.IMG_SIZE = 512

    c.OUTPUT = ConfigNode()
    c.OUTPUT.DIR = "./output/full_transfer/"
    c.OUTPUT.FILE_NAME = "res.jpg"
    c.OUTPUT.HR_FILE_NAME = "hr_res.jpg"

    return c


# --------------------------------------------------------------------------- #
# pix2pixHD legacy opt.txt ingestion
# --------------------------------------------------------------------------- #
_OPT_LINE = re.compile(r"^\s*([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*?)\s*$")


def parse_opt_txt(path_or_text: str) -> Dict[str, Any]:
    """Parse a legacy pix2pixHD ``opt.txt`` snapshot into a flat dict.

    The reference persists experiment options in the format written by
    ``p2pHD/options/base_options.py:100-106``::

        ------------ Options -------------
        batchSize: 2
        netG: UNet
        ...
        -------------- End ----------------

    Values are recovered with Python literal semantics where possible
    (ints, floats, bools, lists); everything else stays a string.
    """
    if "\n" in path_or_text or not os.path.exists(path_or_text):
        text = path_or_text
    else:
        with open(path_or_text, "r") as f:
            text = f.read()
    out: Dict[str, Any] = {}
    for line in text.splitlines():
        if line.startswith("---"):
            continue
        m = _OPT_LINE.match(line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        if raw in ("True", "False", "None"):
            out[key] = {"True": True, "False": False, "None": None}[raw]
        else:
            out[key] = _literal(raw)
    return out
