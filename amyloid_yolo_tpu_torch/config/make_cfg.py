"""Regenerate the port's shipped darknet-format model config.

The original generates its cfg with a sed script
(``config/create_custom_model.sh``); here the model's definition is the
Python builder :func:`~amyloid_yolo_tpu_torch.graphspec.yolov3_spec`, and
the cfg is its serialization (:func:`~amyloid_yolo_tpu_torch.graphspec.
emit_cfg`), byte-equal to the reference package's ``yolov3-amyloid.cfg``.

Usage: ``python -m amyloid_yolo_tpu_torch.config.make_cfg [num_classes]``
"""

import os
import sys

from ..graphspec import emit_cfg, yolov3_spec


def main(num_classes: int = 2) -> str:
    path = os.path.join(os.path.dirname(__file__), "yolov3-amyloid.cfg")
    with open(path, "w") as fh:
        fh.write(emit_cfg(yolov3_spec(num_classes)))
    return path


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(main(n))
