"""PyTorch/CUDA port of the amyloid-plaque YOLOv3 tile detector for one
NVIDIA H100.

The JAX package beside this one stays the reference; this package imports
``torch`` and never ``jax`` nor anything of the JAX package.  Module names
mirror the reference's so each counterpart is easy to find:

* :mod:`.graphspec`, :mod:`.parsecfg` — the static model graph;
* :mod:`.io.weights` — JAX pytrees, reference ``.pth`` and darknet binaries;
* :mod:`.models.darknet` — BN folding and the folded inference executor;
* :mod:`.models.heads` — score → top-k → sparse decode (and dense decode);
* :mod:`.ops.preprocess`, :mod:`.ops.boxes`, :mod:`.ops.nms`;
* :mod:`.kernels` — the hand-written Hopper kernels (K1 preprocess, K2 fused
  residual unit, K3 its int8 form), built with ``nvcc`` at first use;
* :mod:`.io.datasets`, :mod:`.io.native`, :mod:`.io.tissue` — the folder
  reader (the native libjpeg pool of ``csrc/tile_reader.cc``, built with
  ``g++`` at first use, or PIL) and the background prefilter;
* :mod:`.ops.merge`, :mod:`.models.classifier`, :mod:`.domain` — the union
  merge and the consensus-model CAA filter;
* :mod:`.detectors` — :class:`~.detectors.Detector`, the end-to-end path,
  and its ``detect_folder``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
