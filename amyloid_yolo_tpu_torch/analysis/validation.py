"""The whole-slide sweep: per-WSI and per-tile plaque counts.

Counterpart of the sweep part of the reference package's
``analysis/validation.py`` (``get_stain`` and
``calculate_plaque_counts_per_wsi``, its ``:43-192``), after the original
``validation.py:30-175``: the detector over every 1536² tile of every WSI,
the per-tile rescale, union merge and CAA filter, optionally the cross-tile
merge, and the two count pickles in the original's dict shapes.  The CERAD
plots and statistics, the speed check and the sliding-window comparison
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..detectors import Detector
from ..domain import CAAFilter, draw_detections
from ..io.datasets import ImageFolder, load_image_rgb
from ..io.tiles import iter_wsi_tile_dirs, tile_origin
from ..io.tissue import prefilter_tile_paths
from ..ops.merge import merge_wsi_detections


def get_stain(string: str) -> str:
    """Parity ``validation.py:264-280``."""
    if "4G8" in string:
        return "4G8"
    if "Abeta42" in string:
        return "ABeta42"
    if "Abeta40" in string:
        return "ABeta40"
    if "beta_amyloid" in string:
        return "6E10"
    raise Exception(f"cannot determine stain from string: {string}")


def calculate_plaque_counts_per_wsi(
    directory: str,
    detector: Detector,
    caa_filter: Optional[CAAFilter] = None,
    prefix: str = "CERAD_",
    pickles_dir: str = "pickles",
    batch_size: int = 8,
    classes: Sequence[str] = ("CAA", "Cored"),
    save_images: bool = False,
    output_dir: str = "output",
    wsi_whitelist: Optional[Sequence[str]] = None,
    cross_tile_merge: bool = False,
    background_skip: bool = False,
    background_max_bpp: Optional[float] = None,
    background_min_tissue: Optional[float] = None,
) -> Dict[str, Dict[str, int]]:
    """Sweep every tile of every WSI under ``directory``.

    ``background_skip=True`` runs the sweep-time background prefilter
    (:func:`~amyloid_yolo_tpu_torch.io.tissue.prefilter_tile_paths`: a free
    file-size stage, then a cheap decode-confirm stage) before any tile is
    decoded at full size: the host decode is the sweep's bottleneck and
    real WSIs are mostly background.  Skipped tiles still get zero-count
    entries in the per-tile dictionary (the reference records every tile).
    Default off, as in the reference package.

    Saves ``<prefix>WSI_plaque_counts_dictionary.pkl`` and
    ``<prefix>1536_plaque_counts_dictionary.pkl`` with the reference's
    exact dict shapes (``validation.py:71-76,173-174``).

    ``cross_tile_merge=True`` additionally merges detections ACROSS
    adjacent tile boundaries (new capability — the reference merges only
    within a tile, ``validation.py:127-129``, double-counting plaques that
    straddle a boundary).  Per-tile merge + CAA filter run first with exact
    reference semantics; then :func:`~amyloid_yolo_tpu_torch.ops.merge.
    merge_wsi_detections` unifies straddlers in slide space, and each
    merged box counts once, toward the tile containing its center.

    Each row directory goes through :meth:`~amyloid_yolo_tpu_torch.detectors.
    Detector.detect_dataset`: the per-tile rescale, merge and CAA filter of
    ``detect_folder``, with its device pipeline and its int8 calibration;
    the sweep only prefilters, counts and merges across tiles.
    """
    os.makedirs(pickles_dir, exist_ok=True)
    wsi_names = sorted(os.listdir(directory))
    wsi_counts: Dict[str, Dict[str, int]] = {w: {"Cored": 0, "CAA": 0} for w in wsi_names}
    tile_counts: Dict[str, Dict[str, Dict[str, int]]] = {w: {} for w in wsi_names}

    def save_tile_render(path, dets):
        os.makedirs(output_dir, exist_ok=True)
        img = load_image_rgb(path)
        out = draw_detections(img, dets, classes)
        from PIL import Image

        out_name = path.replace("/", "_").replace(".jpg", "") + ".png"
        Image.fromarray(out).save(os.path.join(output_dir, out_name))

    # group row-subdirectories by WSI so cross-tile merging sees every
    # tile of a slide at once
    dirs_by_wsi: Dict[str, List[str]] = {}
    for wsi, tile_dir in iter_wsi_tile_dirs(directory):
        dirs_by_wsi.setdefault(wsi, []).append(tile_dir)

    for wsi, tile_dirs in dirs_by_wsi.items():
        if wsi_whitelist is not None and wsi not in wsi_whitelist:
            continue
        dets_by_path: Dict[str, Optional[np.ndarray]] = {}
        n_skipped = 0
        n_total = 0
        for tile_dir in tile_dirs:
            folder = ImageFolder(
                tile_dir, tile_size=detector.tile_size,
                resize_to=detector.model_size if detector.host_resize else None)
            n_total += len(folder.files)
            if background_skip:
                kw = {}
                if background_max_bpp is not None:
                    kw["max_bpp"] = background_max_bpp
                if background_min_tissue is not None:
                    kw["min_tissue"] = background_min_tissue
                folder.files, skipped = prefilter_tile_paths(folder.files, **kw)
                n_skipped += len(skipped)
                for p in skipped:  # reference records every tile: 0 counts
                    tile_counts[wsi].setdefault(p, {"Cored": 0, "CAA": 0})
            if not folder.files:
                continue
            found = detector.detect_dataset(
                folder, batch_size, merge_boxes=True,
                caa_filter=caa_filter.filter_path if caa_filter is not None else None)
            for path, dets in found.items():
                tile_counts[wsi].setdefault(path, {"Cored": 0, "CAA": 0})
                if dets is None or len(dets) == 0:
                    continue
                dets_by_path[path] = dets
                if save_images:
                    save_tile_render(path, dets)

        if background_skip and n_total:
            print(f"{wsi}: background prefilter skipped {n_skipped}/{n_total} "
                  f"tiles ({100.0 * n_skipped / n_total:.1f}%)", flush=True)

        if cross_tile_merge:
            origins = {p: tile_origin(p, detector.tile_size)
                       for p in dets_by_path}
            rows, owners = merge_wsi_detections(
                dets_by_path, origins, tile_size=detector.tile_size)
            for row, owner in zip(rows, owners):
                name = classes[int(row[6])]
                wsi_counts[wsi][name] += 1
                tile_counts[wsi][owner][name] += 1
        else:
            for path, dets in dets_by_path.items():
                for row in dets:
                    name = classes[int(row[6])]
                    wsi_counts[wsi][name] += 1
                    tile_counts[wsi][path][name] += 1

    if getattr(detector, "overflow_images", 0):
        import warnings

        warnings.warn(
            f"WSI sweep: {detector.overflow_images}/{detector.images_seen} "
            f"tiles exceeded the NMS candidate pool "
            f"(nms_pool={detector.nms_pool}, max seen "
            f"{detector.max_candidates_seen}) — detections were truncated "
            f"on those tiles; rebuild the Detector with a larger nms_pool/"
            f"capacity for uncapped-reference parity.", UserWarning,
            stacklevel=2)
    with open(os.path.join(pickles_dir, prefix + "WSI_plaque_counts_dictionary.pkl"), "wb") as fh:
        pickle.dump(wsi_counts, fh)
    with open(os.path.join(pickles_dir, prefix + "1536_plaque_counts_dictionary.pkl"), "wb") as fh:
        pickle.dump(tile_counts, fh)
    return wsi_counts


__all__ = ["get_stain", "calculate_plaque_counts_per_wsi"]
