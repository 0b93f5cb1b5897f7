"""A darknet ``.cfg`` read into a plain list of layers.

The reference builds its graph from the frozen ``.cfg`` beside each
configuration, with this parser of its own: ``[type]`` headers followed by
``key=value`` lines, ``#`` comments.  Route and shortcut sources are
resolved to absolute layer indices and every layer records its output
channels.  The ``yolo`` constants follow the original PyTorch-YOLOv3
``YOLOLayer``: ignore threshold 0.5 (the cfg's ``ignore_thresh`` is not
read there), object scale 1, no-object scale 100.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

IGNORE_THRES = 0.5
OBJ_SCALE = 1.0
NOOBJ_SCALE = 100.0


def blocks(path: str) -> List[Dict[str, str]]:
    out: List[Dict[str, str]] = []
    with open(path) as fh:
        for raw in fh.read().split("\n"):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("["):
                out.append({"type": line[1:-1].strip()})
            else:
                key, value = line.split("=", 1)
                out[-1][key.strip()] = value.strip()
    return out


def layers(path: str) -> Tuple[Dict[str, str], List[dict]]:
    """``(net block, layers)``; each layer a dict with ``type`` one of
    ``conv``, ``upsample``, ``route``, ``shortcut``, ``yolo``, ``maxpool``
    and ``cout``, its output channels."""
    bl = blocks(path)
    net, rest = bl[0], bl[1:]
    if net["type"] != "net":
        raise ValueError(f"{path}: the first block is not [net]")
    out: List[dict] = []
    chans: List[int] = []
    for i, b in enumerate(rest):
        t = b["type"]
        prev = chans[-1] if chans else int(net.get("channels", 3))
        if t == "convolutional":
            k = int(b["size"])
            layer = {"type": "conv", "cin": prev, "cout": int(b["filters"]), "k": k,
                     "stride": int(b["stride"]),
                     "pad": (k - 1) // 2 if int(b.get("pad", 0)) else 0,
                     "bn": int(b.get("batch_normalize", 0)) == 1,
                     "leaky": b.get("activation", "linear") == "leaky"}
        elif t == "upsample":
            layer = {"type": "upsample", "factor": int(b["stride"]), "cout": prev}
        elif t == "maxpool":
            layer = {"type": "maxpool", "k": int(b["size"]), "stride": int(b["stride"]),
                     "cout": prev}
        elif t == "route":
            srcs = [int(s) if int(s) >= 0 else i + int(s) for s in b["layers"].split(",")]
            layer = {"type": "route", "srcs": srcs, "cout": sum(chans[s] for s in srcs)}
        elif t == "shortcut":
            src = int(b["from"])
            src = src if src >= 0 else i + src
            layer = {"type": "shortcut", "src": src, "cout": chans[src]}
        elif t == "yolo":
            flat = [float(a) for a in b["anchors"].split(",")]
            table = [(flat[j], flat[j + 1]) for j in range(0, len(flat), 2)]
            anchors = [table[int(m)] for m in b["mask"].split(",")]
            layer = {"type": "yolo", "anchors": anchors, "classes": int(b["classes"]),
                     "cout": prev}
        else:
            raise ValueError(f"{path}: layer type {t!r} is not in the reference")
        out.append(layer)
        chans.append(layer["cout"])
    return net, out


def conv_key(i: int) -> str:
    return f"module_list.{i}.conv_{i}"


def bn_key(i: int) -> str:
    return f"module_list.{i}.batch_norm_{i}"


def residual_units(layer_list: List[dict]) -> List[int]:
    """Start indices of the residual units: a 1×1/s1 conv halving the
    width, a 3×3/s1 conv back to it, both with BN and leaky, and a
    shortcut from the unit's input."""
    starts = []
    for i in range(len(layer_list) - 2):
        a, b, s = layer_list[i:i + 3]
        if (a["type"] == "conv" and a["k"] == 1 and a["stride"] == 1 and a["bn"] and a["leaky"]
                and b["type"] == "conv" and b["k"] == 3 and b["stride"] == 1 and b["bn"]
                and b["leaky"] and b["cin"] == a["cout"] and b["cout"] == a["cin"]
                and s["type"] == "shortcut" and s["src"] == i - 1):
            starts.append(i)
    return starts
