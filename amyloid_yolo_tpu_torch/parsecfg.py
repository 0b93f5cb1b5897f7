"""Darknet-format configuration parsers.

The same ``.cfg`` block format (``[type]`` headers followed by
``key=value`` lines, ``#`` comments) and ``.data`` key=value dataset
descriptors as the reference repo's ``utils/parse_config.py:3-36``.  The
parsed block dicts are compiled once into a static
:class:`~amyloid_yolo_tpu_torch.graphspec.GraphSpec` that the executor in
:mod:`amyloid_yolo_tpu_torch.models.darknet` walks.

This module is the port's own copy of the reference package's parser: the
port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, List


def parse_model_config(path: str) -> List[Dict[str, str]]:
    """Parse a darknet ``.cfg`` file into a list of block dicts.

    Every block dict has a ``type`` key holding the bracketed section name;
    remaining keys are the raw string key=value pairs.  Convolutional blocks
    default ``batch_normalize`` to ``0`` (same convention as the reference
    parser, ``utils/parse_config.py:14-15``).
    """
    with open(path, "r") as fh:
        raw_lines = fh.read().split("\n")

    blocks: List[Dict[str, str]] = []
    for raw in raw_lines:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            block: Dict[str, str] = {"type": line[1:-1].strip()}
            if block["type"] == "convolutional":
                block["batch_normalize"] = "0"
            blocks.append(block)
        else:
            if "=" not in line:
                raise ValueError(f"malformed cfg line (expected key=value): {line!r}")
            key, value = line.split("=", 1)
            blocks[-1][key.strip()] = value.strip()
    return blocks


def parse_data_config(path: str) -> Dict[str, str]:
    """Parse a ``.data`` dataset descriptor (key=value per line).

    Mirrors ``utils/parse_config.py:23-36`` including its defaults for
    ``gpus``/``num_workers`` (kept for drop-in compatibility; the port picks
    its device from the ``device`` argument of its entry points).
    """
    options: Dict[str, str] = {"gpus": "0,1,2,3", "num_workers": "10"}
    with open(path, "r") as fh:
        for raw in fh.readlines():
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            key, value = line.split("=", 1)
            options[key.strip()] = value.strip()
    return options


def load_classes(path: str) -> List[str]:
    """Load class names, one per line (parity: ``utils/utils.py:18-24``).

    The reference drops the final newline-split element; we keep every
    non-empty line, which is equivalent for well-formed files.
    """
    with open(path, "r") as fh:
        return [ln for ln in fh.read().split("\n") if ln != ""]


__all__ = ["parse_model_config", "parse_data_config", "load_classes"]
