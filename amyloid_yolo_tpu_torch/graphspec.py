"""Static graph specification for darknet-style detection networks.

A ``.cfg`` is compiled **once** into an immutable :class:`GraphSpec`: a
tuple of layer dataclasses with route / shortcut references resolved to
absolute indices, channel counts precomputed, and the consumer set of every
layer recorded so the executor
(:mod:`amyloid_yolo_tpu_torch.models.darknet`) keeps an activation only
while a later route/shortcut still reads it.

The spec can be built two ways:

* :func:`from_cfg` — parse an existing darknet ``.cfg`` (drop-in parity with
  reference configs such as ``config/yolov3-custom.cfg``).
* :func:`yolov3_spec` — build the YOLOv3 / Darknet-53 architecture natively
  in Python; :func:`emit_cfg` writes it back out in darknet format.

This module is the port's own copy of the reference package's graph spec:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import FrozenSet, List, Optional, Sequence, Tuple

from .parsecfg import parse_model_config


@dataclasses.dataclass(frozen=True)
class NetInfo:
    """Hyperparameters from the ``[net]`` block.

    The reference parses these but its trainer ignores lr/momentum/decay/
    burn_in (plain ``Adam(model.parameters())`` at ``train.py:81``); we carry
    them so a trainer *may* honor them, and default to reference behavior.
    """

    width: int = 416
    height: int = 416
    channels: int = 3
    batch: int = 16
    momentum: float = 0.9
    decay: float = 5e-4
    learning_rate: float = 1e-3
    burn_in: int = 1000


#: the conv activations the executors compute; :func:`from_cfg` refuses others
ACTIVATIONS = ("leaky", "mish", "linear")


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Conv (+ optional BN, + optional activation) — reference ``models.py:26-45``;
    ``mish`` is YOLOv4's CSPDarknet53 activation, ``x·tanh(softplus(x))``."""

    index: int
    in_ch: int
    out_ch: int
    kernel: int
    stride: int
    batch_normalize: bool
    activation: str  # one of ACTIVATIONS

    @property
    def pad(self) -> int:
        return (self.kernel - 1) // 2


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    index: int
    kernel: int
    stride: int


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    index: int
    factor: int


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """Concatenate previous layer outputs along channels (``models.py:244-245``)."""

    index: int
    layers: Tuple[int, ...]  # absolute layer indices


@dataclasses.dataclass(frozen=True)
class ShortcutSpec:
    """Residual add with an earlier layer (``models.py:246-248``)."""

    index: int
    from_index: int  # absolute layer index


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """One detection head scale (``models.py:98-125``)."""

    index: int
    anchors: Tuple[Tuple[float, float], ...]  # the masked (per-scale) anchors
    num_classes: int
    ignore_thres: float = 0.5
    obj_scale: float = 1.0
    noobj_scale: float = 100.0
    #: YOLOv4's grid-sensitive decode: centre ``σ(t)·s − (s−1)/2 + cell``
    scale_x_y: float = 1.0


LayerSpec = object  # union of the dataclasses above


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    net: NetInfo
    layers: Tuple[LayerSpec, ...]
    out_channels: Tuple[int, ...]  # per-layer output channel count
    # for each layer index, the set of later layers that read its output via
    # route/shortcut (used by the executor to keep only live activations)
    consumers: Tuple[FrozenSet[int], ...]

    @property
    def yolo_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.layers) if isinstance(l, YoloSpec))

    @property
    def conv_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, l in enumerate(self.layers) if isinstance(l, ConvSpec))

    @property
    def num_classes(self) -> int:
        for l in self.layers:
            if isinstance(l, YoloSpec):
                return l.num_classes
        raise ValueError("graph has no yolo layers")


def _resolve(idx_str: str, current: int) -> int:
    i = int(idx_str)
    return i if i >= 0 else current + i


def from_cfg(path: str) -> GraphSpec:
    """Compile a darknet ``.cfg`` into a :class:`GraphSpec`.

    Follows the same channel-tracking rules as the reference's
    ``create_modules`` (``models.py:16-83``): routes sum the channel counts of
    their source layers, shortcuts inherit the channel count of their source.
    A conv activation outside :data:`ACTIVATIONS` raises; the ``[yolo]`` keys
    that only darknet's training reads (``iou_loss``, ``iou_normalizer``,
    ``max_delta``, ``nms_kind``, ...) are ignored, and ``scale_x_y`` is kept.
    """
    blocks = parse_model_config(path)
    hyper = blocks[0]
    if hyper["type"] != "net":
        raise ValueError("cfg must start with a [net] block")
    net = NetInfo(
        width=int(hyper.get("width", 416)),
        height=int(hyper.get("height", 416)),
        channels=int(hyper.get("channels", 3)),
        batch=int(hyper.get("batch", 16)),
        momentum=float(hyper.get("momentum", 0.9)),
        decay=float(hyper.get("decay", 5e-4)),
        learning_rate=float(hyper.get("learning_rate", 1e-3)),
        burn_in=int(hyper.get("burn_in", 1000)),
    )

    layers: List[LayerSpec] = []
    out_channels: List[int] = []

    def prev_ch(i: int = -1) -> int:
        return out_channels[i] if out_channels else net.channels

    for li, block in enumerate(blocks[1:]):
        btype = block["type"]
        if btype == "convolutional":
            act = block.get("activation", "linear")
            if act not in ACTIVATIONS:
                raise ValueError(f"layer {li}: unsupported activation {act!r} "
                                 f"(the executors compute {', '.join(ACTIVATIONS)})")
            spec = ConvSpec(
                index=li,
                in_ch=prev_ch(),
                out_ch=int(block["filters"]),
                kernel=int(block["size"]),
                stride=int(block["stride"]),
                batch_normalize=bool(int(block.get("batch_normalize", "0"))),
                activation=act,
            )
            layers.append(spec)
            out_channels.append(spec.out_ch)
        elif btype == "maxpool":
            layers.append(MaxPoolSpec(li, int(block["size"]), int(block["stride"])))
            out_channels.append(prev_ch())
        elif btype == "upsample":
            layers.append(UpsampleSpec(li, int(block["stride"])))
            out_channels.append(prev_ch())
        elif btype == "route":
            srcs = tuple(_resolve(s, li) for s in block["layers"].split(","))
            layers.append(RouteSpec(li, srcs))
            out_channels.append(sum(out_channels[s] for s in srcs))
        elif btype == "shortcut":
            src = _resolve(block["from"], li)
            layers.append(ShortcutSpec(li, src))
            out_channels.append(out_channels[src])
        elif btype == "yolo":
            mask = [int(m) for m in block["mask"].split(",")]
            flat = [float(a) for a in block["anchors"].split(",")]
            all_anchors = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
            anchors = tuple(all_anchors[m] for m in mask)
            layers.append(
                YoloSpec(
                    index=li,
                    anchors=anchors,
                    num_classes=int(block["classes"]),
                    ignore_thres=0.5,  # reference hard-codes 0.5 (models.py:106),
                    # NOT the cfg's ignore_thresh=.7 — documented trap.
                    scale_x_y=float(block.get("scale_x_y", 1.0)),
                )
            )
            out_channels.append(prev_ch())
        else:
            raise ValueError(f"unsupported layer type: {btype!r}")

    return _finish(net, layers, out_channels)


def _finish(net: NetInfo, layers: Sequence[LayerSpec], out_channels: Sequence[int]) -> GraphSpec:
    consumers: List[set] = [set() for _ in layers]
    for i, l in enumerate(layers):
        if isinstance(l, RouteSpec):
            for s in l.layers:
                consumers[s].add(i)
        elif isinstance(l, ShortcutSpec):
            consumers[l.from_index].add(i)
            consumers[i - 1].add(i)  # shortcut also reads the immediately previous layer
    return GraphSpec(
        net=net,
        layers=tuple(layers),
        out_channels=tuple(out_channels),
        consumers=tuple(frozenset(c) for c in consumers),
    )


# ---------------------------------------------------------------------------
# Native builder: YOLOv3 (Darknet-53 backbone + 3-scale heads)
# ---------------------------------------------------------------------------

YOLOV3_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
    (116, 90), (156, 198), (373, 326),
)
YOLOV3_MASKS: Tuple[Tuple[int, ...], ...] = ((6, 7, 8), (3, 4, 5), (0, 1, 2))


class _Builder:
    def __init__(self, net: NetInfo):
        self.net = net
        self.layers: List[LayerSpec] = []
        self.out_channels: List[int] = []

    @property
    def i(self) -> int:
        return len(self.layers)

    def conv(self, filters: int, kernel: int, stride: int = 1, bn: bool = True,
             act: str = "leaky") -> int:
        in_ch = self.out_channels[-1] if self.out_channels else self.net.channels
        self.layers.append(ConvSpec(self.i, in_ch, filters, kernel, stride, bn, act))
        self.out_channels.append(filters)
        return self.i - 1

    def shortcut(self, from_rel: int) -> int:
        src = self.i + from_rel
        self.layers.append(ShortcutSpec(self.i, src))
        self.out_channels.append(self.out_channels[src])
        return self.i - 1

    def route(self, rels: Sequence[int]) -> int:
        srcs = tuple(r if r >= 0 else self.i + r for r in rels)
        self.layers.append(RouteSpec(self.i, srcs))
        self.out_channels.append(sum(self.out_channels[s] for s in srcs))
        return self.i - 1

    def upsample(self, factor: int = 2) -> int:
        self.layers.append(UpsampleSpec(self.i, factor))
        self.out_channels.append(self.out_channels[-1])
        return self.i - 1

    def yolo(self, mask: Sequence[int], num_classes: int,
             table: Optional[Sequence[Tuple[float, float]]] = None) -> int:
        table = YOLOV3_ANCHORS if table is None else tuple(table)
        anchors = tuple(table[m] for m in mask)
        self.layers.append(YoloSpec(self.i, anchors, num_classes))
        self.out_channels.append(self.out_channels[-1])
        return self.i - 1


def yolov3_spec(
    num_classes: int = 2, img_size: int = 416,
    anchors: Optional[Sequence[Tuple[float, float]]] = None,
) -> GraphSpec:
    """Build YOLOv3 (Darknet-53 + FPN heads) natively.

    Structurally identical to the reference's ``config/yolov3-custom.cfg``
    (75-layer backbone, heads at strides 32/16/8 with anchor masks 6-8 / 3-5 /
    0-2, ``filters = 3*(5+num_classes)`` on each pre-yolo 1x1 conv).

    ``anchors`` replaces the 9-entry COCO table (``YOLOV3_ANCHORS``) with a
    custom one, in input pixels at ``img_size`` scale, area-ascending so the
    standard masks keep assigning the largest triple to the stride-32 head.
    The reference hardcodes the COCO anchors for every experiment
    (``config/create_custom_model.sh``); re-estimated anchors are the one
    standard YOLO training lever it omits (see ``tools/estimate_anchors.py``).
    """
    b = _Builder(NetInfo(width=img_size, height=img_size))
    head_filters = 3 * (5 + num_classes)

    def residual_block(filters: int):
        b.conv(filters // 2, 1)
        b.conv(filters, 3)
        b.shortcut(-3)

    # Darknet-53 backbone
    b.conv(32, 3)
    b.conv(64, 3, stride=2)
    residual_block(64)
    b.conv(128, 3, stride=2)
    for _ in range(2):
        residual_block(128)
    b.conv(256, 3, stride=2)
    for _ in range(8):
        residual_block(256)
    route_36 = b.i - 1  # stride-8 features
    b.conv(512, 3, stride=2)
    for _ in range(8):
        residual_block(512)
    route_61 = b.i - 1  # stride-16 features
    b.conv(1024, 3, stride=2)
    for _ in range(4):
        residual_block(1024)

    # Head 1 (stride 32)
    for _ in range(2):
        b.conv(512, 1)
        b.conv(1024, 3)
    b.conv(512, 1)
    b.conv(1024, 3)
    b.conv(head_filters, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[0], num_classes, anchors)

    # Head 2 (stride 16)
    b.route([-4])
    b.conv(256, 1)
    b.upsample(2)
    b.route([-1, route_61])
    for _ in range(2):
        b.conv(256, 1)
        b.conv(512, 3)
    b.conv(256, 1)
    b.conv(512, 3)
    b.conv(head_filters, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[1], num_classes, anchors)

    # Head 3 (stride 8)
    b.route([-4])
    b.conv(128, 1)
    b.upsample(2)
    b.route([-1, route_36])
    for _ in range(2):
        b.conv(128, 1)
        b.conv(256, 3)
    b.conv(128, 1)
    b.conv(256, 3)
    b.conv(head_filters, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[2], num_classes, anchors)

    return _finish(b.net, b.layers, b.out_channels)


def emit_cfg(spec: GraphSpec) -> str:
    """Serialize a :class:`GraphSpec` back to darknet ``.cfg`` text."""
    out: List[str] = []
    n = spec.net
    out.append("[net]")
    out.append(f"batch={n.batch}")
    out.append("subdivisions=1")
    out.append(f"width={n.width}")
    out.append(f"height={n.height}")
    out.append(f"channels={n.channels}")
    out.append(f"momentum={n.momentum}")
    out.append(f"decay={n.decay}")
    out.append(f"learning_rate={n.learning_rate}")
    out.append(f"burn_in={n.burn_in}")
    out.append("")
    flat_anchors = ",  ".join(f"{int(a[0])},{int(a[1])}" for a in YOLOV3_ANCHORS)
    for i, l in enumerate(spec.layers):
        if isinstance(l, ConvSpec):
            out.append("[convolutional]")
            if l.batch_normalize:
                out.append("batch_normalize=1")
            out.append(f"filters={l.out_ch}")
            out.append(f"size={l.kernel}")
            out.append(f"stride={l.stride}")
            out.append("pad=1")
            out.append(f"activation={l.activation}")
        elif isinstance(l, MaxPoolSpec):
            out.append("[maxpool]")
            out.append(f"size={l.kernel}")
            out.append(f"stride={l.stride}")
        elif isinstance(l, UpsampleSpec):
            out.append("[upsample]")
            out.append(f"stride={l.factor}")
        elif isinstance(l, RouteSpec):
            out.append("[route]")
            out.append("layers=" + ",".join(str(s - i if s < i else s) for s in l.layers))
        elif isinstance(l, ShortcutSpec):
            out.append("[shortcut]")
            out.append(f"from={l.from_index - i}")
            out.append("activation=linear")
        elif isinstance(l, YoloSpec):
            out.append("[yolo]")
            if all(a in YOLOV3_ANCHORS for a in l.anchors):
                # standard table: recover the reference cfg's mask indices
                mask = tuple(YOLOV3_ANCHORS.index(a) for a in l.anchors)
                anchors, num = flat_anchors, 9
            else:  # non-standard anchors (e.g. tiny cfgs): emit as-is
                mask = tuple(range(len(l.anchors)))
                anchors = ",  ".join(f"{int(w)},{int(h)}"
                                     for w, h in l.anchors)
                num = len(l.anchors)
            out.append("mask=" + ",".join(str(m) for m in mask))
            out.append(f"anchors={anchors}")
            out.append(f"classes={l.num_classes}")
            out.append(f"num={num}")
            if l.scale_x_y != 1.0:
                out.append(f"scale_x_y={l.scale_x_y!r}")
            out.append("jitter=.3")
            out.append("ignore_thresh=.7")
            out.append("truth_thresh=1")
            out.append("random=1")
        out.append("")
    return "\n".join(out)


__all__ = [
    "NetInfo", "ConvSpec", "MaxPoolSpec", "UpsampleSpec", "RouteSpec",
    "ShortcutSpec", "YoloSpec", "GraphSpec", "from_cfg", "yolov3_spec",
    "emit_cfg", "YOLOV3_ANCHORS", "YOLOV3_MASKS", "ACTIVATIONS",
]
