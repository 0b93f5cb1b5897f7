"""WSI tiling: whole-slide images → 1536² JPEG tiles.

Counterpart of the reference package's ``io/tiles.py``, after the original
``crop.py:13-162``: pyvips ``dzsave`` google-layout tiling with the 40x→20x
downscale, the divide-and-conquer fallback for slides that crash the tiler,
the directory merge and the temp-name repair.  The directory contract is
the same (``<out>/<WSI>/0/<r>/<c>.jpg``, the google layout), so the sweep
(:mod:`amyloid_yolo_tpu_torch.analysis.validation`) reads either tree.

pyvips is optional: :func:`tile_image_array` is a numpy/PIL tiler with the
same tile geometry for images that fit in memory, and every pyvips path is
gated behind :func:`have_pyvips`; without pyvips the port behaves as the
reference package does (the PIL path of :func:`save_and_tile`, the same
error from :func:`divide_and_conquer`).  Host code only: nothing here
touches the GPU.
"""

from __future__ import annotations

import os
import pickle
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np

TILE_SIZE = 1536
SUPERCROP = TILE_SIZE * 16  # divide-and-conquer crop size (crop.py:72)


def have_pyvips() -> bool:
    try:
        import pyvips  # noqa: F401

        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Pure-Python tiler (fallback + testable core)
# ---------------------------------------------------------------------------

def tile_image_array(img: np.ndarray, out_dir: str, name: str,
                     tile_size: int = TILE_SIZE, quality: int = 90,
                     min_tissue_fraction: float = 0.0,
                     skipped_out: Optional[List[Tuple[int, int]]] = None,
                     ) -> List[str]:
    """Tile an HWC uint8 array into ``<out_dir>/<name>/0/<row>/<col>.jpg``.

    True dzsave google layout (zoom dir ``0``, one subdirectory per tile
    row, column index as the file name), row-major; edge tiles keep their
    partial size (dzsave behavior).  Returns written paths.  The grid
    coordinates are recoverable from any path via :func:`tile_origin` —
    the cross-tile merge relies on that.

    ``min_tissue_fraction`` > 0 enables crop-time background suppression:
    tiles whose :func:`~amyloid_yolo_tpu_torch.io.tissue.tissue_fraction`
    falls below it are never written — the statistic is ~free while the
    pixels are in hand, and every skipped tile saves a JPEG encode now
    plus a Huffman decode per future sweep.  Skipped grid coords go to
    ``skipped_out`` when given.  Default 0.0 = reference behavior (write
    everything).
    """
    from PIL import Image

    from .tissue import tissue_fraction

    base = os.path.join(out_dir, name, "0")
    h, w = img.shape[:2]
    paths = []
    for row, top in enumerate(range(0, h, tile_size)):
        row_dir = os.path.join(base, str(row))
        os.makedirs(row_dir, exist_ok=True)
        for col, left in enumerate(range(0, w, tile_size)):
            tile = img[top:top + tile_size, left:left + tile_size]
            if (min_tissue_fraction > 0.0
                    and tissue_fraction(tile) < min_tissue_fraction):
                if skipped_out is not None:
                    skipped_out.append((row, col))
                continue
            p = os.path.join(row_dir, f"{col}.jpg")
            Image.fromarray(tile).save(p, quality=quality)
            paths.append(p)
    return paths


def tile_origin(path: str, tile_size: int = TILE_SIZE) -> Optional[Tuple[int, int]]:
    """Slide-space origin ``(ox, oy)`` of a google-layout tile path.

    Parses ``.../<WSI>/0/<row>/<col>.jpg`` → ``(col * tile_size,
    row * tile_size)``.  Returns ``None`` when the path does not encode a
    grid position (flat legacy layouts, divide-and-conquer renames like
    ``<WSI>_<i>_<sub>`` — those tiles fall back to within-tile counting).
    """
    parts = os.path.normpath(path).split(os.sep)
    if len(parts) < 3:
        return None
    stem = os.path.splitext(parts[-1])[0]
    row = parts[-2]
    if not (stem.isdigit() and row.isdigit()):
        return None
    # guard against flat layouts where parts[-2] is the zoom dir "0" and the
    # file name is a flat index: require the zoom dir one level further up
    if len(parts) >= 3 and parts[-3] == "0":
        return int(stem) * tile_size, int(row) * tile_size
    return None


def save_and_tile(image_path: str, output_dir: str, tile_size: int = TILE_SIZE,
                  min_tissue_fraction: float = 0.0) -> None:
    """Tile one slide file (pyvips when available, PIL fallback).

    pyvips path mirrors ``save_and_tile`` (``crop.py:13-25``): google
    layout, ``.jpg[Q=90]``, depth one.

    ``min_tissue_fraction``: crop-time background suppression for the PIL
    tiler path (see :func:`tile_image_array`).  The pyvips ``dzsave`` path
    writes everything (no per-tile hook) — prune dzsave trees with the
    sweep-time prefilter (:mod:`amyloid_yolo_tpu_torch.io.tissue`) instead.
    """
    basename = os.path.basename(image_path)
    name = basename.split(".svs")[0].rsplit(".", 1)[0] if ".svs" not in basename \
        else basename.split(".svs")[0]
    if have_pyvips():
        import pyvips

        img = pyvips.Image.new_from_file(image_path, level=0) \
            if image_path.endswith(".svs") else pyvips.Image.new_from_file(image_path)
        if image_path.endswith(".svs"):
            try:
                if img.get("aperio.AppMag") == "40":  # 40x -> 20x (crop.py:44-47)
                    img = img.resize(0.5)
            except Exception:
                pass
        base_dir = os.path.join(output_dir, name)
        os.makedirs(base_dir, exist_ok=True)
        pyvips.Image.dzsave(
            img, base_dir, layout="google", suffix=f".jpg[Q=90]",
            tile_size=tile_size, depth="one", properties=True,
        )
    else:
        from .datasets import load_image_rgb

        tile_image_array(load_image_rgb(image_path), output_dir, name, tile_size,
                         min_tissue_fraction=min_tissue_fraction)


def divide_and_conquer(image_path: str, output_dir: str,
                       tile_size: int = TILE_SIZE) -> None:
    """Split an oversized slide into 1536·16 super-crops, tiling each into a
    ``<i>_<name>`` directory (``crop.py:63-108`` semantics).  PIL fallback
    only handles in-memory images."""
    if have_pyvips():
        import pyvips

        img = pyvips.Image.new_from_file(image_path, level=0)
        width, height = img.width, img.height
        name = os.path.basename(image_path).split(".svs")[0]
        indice = 0
        for top in range(0, height, SUPERCROP):
            for left in range(0, width, SUPERCROP):
                indice += 1
                w = min(SUPERCROP, width - left)
                h = min(SUPERCROP, height - top)
                crop = img.crop(left, top, w, h)
                base_dir = os.path.join(output_dir, f"{indice}_{name}")
                os.makedirs(base_dir, exist_ok=True)
                pyvips.Image.dzsave(
                    crop, base_dir, layout="google", suffix=".jpg[Q=90]",
                    tile_size=tile_size, depth="one", properties=True,
                )
    else:  # pragma: no cover - requires pyvips-scale inputs
        raise RuntimeError("divide_and_conquer requires pyvips for WSI-scale input")


def crop_wsis(wsi_dirs: List[str], save_dir: str,
              temp_map_pickle: Optional[str] = None,
              min_tissue_fraction: float = 0.0) -> List[str]:
    """Tile every slide under the given directories (``cropCERADWSIs``,
    ``crop.py:27-61``): try the direct tiler, fall back to
    divide-and-conquer, account failures.  Returns failed image names."""
    failed: List[str] = []
    temp_map: Dict[str, str] = {}
    os.makedirs(save_dir, exist_ok=True)
    for wsi_dir in wsi_dirs:
        for imagename in sorted(os.listdir(wsi_dir)):
            path = os.path.join(wsi_dir, imagename)
            try:
                temp_map[path] = imagename.replace(".svs", "")
                save_and_tile(path, save_dir,
                              min_tissue_fraction=min_tissue_fraction)
            except Exception:
                try:
                    divide_and_conquer(path, save_dir)
                except Exception:
                    failed.append(imagename)
    if temp_map_pickle:
        with open(temp_map_pickle, "wb") as fh:
            pickle.dump(temp_map, fh)
    return failed


def merge_1536_subdirectories(dir_1536: str) -> None:
    """Merge ``<i>_<WSI>`` divide-and-conquer outputs back into one
    ``<WSI>/0/`` tree with collision-free names (``crop.py:121-146``)."""
    for subdirectory in sorted(os.listdir(dir_1536)):
        if subdirectory[:2] != "1_":
            continue
        wsi_name = subdirectory[2:]
        target = os.path.join(dir_1536, wsi_name)
        if os.path.isdir(target):
            shutil.rmtree(target)
        os.makedirs(os.path.join(target, "0"))
        counter = 1
        while os.path.isdir(os.path.join(dir_1536, f"{counter}_{wsi_name}")):
            src_root = os.path.join(dir_1536, f"{counter}_{wsi_name}", "0")
            for sub2 in os.listdir(src_root):
                new_name = f"{wsi_name}_{counter}_{sub2}"
                shutil.move(os.path.join(src_root, sub2),
                            os.path.join(target, "0", new_name))
            shutil.rmtree(os.path.join(dir_1536, f"{counter}_{wsi_name}"))
            counter += 1


def rename_temp_directories(dir_1536: str, temp_map_pickle: str) -> None:
    """Repair dzsave temp directory names (``crop.py:148-156``)."""
    with open(temp_map_pickle, "rb") as fh:
        temp_map = pickle.load(fh)
    for temp_name, real in temp_map.items():
        base = os.path.basename(temp_name)
        if "temp" in base and os.path.isdir(os.path.join(dir_1536, base)):
            os.rename(os.path.join(dir_1536, base), os.path.join(dir_1536, real))


def clear_1536_directory(dir_1536: str, holdout_dir: str) -> None:
    """Remove tiled WSIs except hold-outs (``crop.py:110-119``)."""
    holdouts = {x.replace(".svs", "") for x in os.listdir(holdout_dir)}
    for sub in os.listdir(dir_1536):
        if sub not in holdouts:
            shutil.rmtree(os.path.join(dir_1536, sub))


def iter_wsi_tile_dirs(directory: str) -> List[Tuple[str, str]]:
    """Yield (WSI name, tile subdirectory) pairs for sweep code.

    Handles both the reference layout ``<dir>/<WSI>/0/<sub>/...`` (dzsave
    google layout puts tiles in numbered subfolders) and the flat fallback
    layout ``<dir>/<WSI>/0/*.jpg``.
    """
    out = []
    for wsi in sorted(os.listdir(directory)):
        zero = os.path.join(directory, wsi, "0")
        if not os.path.isdir(zero):
            continue
        entries = sorted(os.listdir(zero))
        subdirs = [e for e in entries if os.path.isdir(os.path.join(zero, e))]
        if subdirs:
            for s in subdirs:
                out.append((wsi, os.path.join(zero, s)))
        elif entries:
            out.append((wsi, zero))
    return out


__all__ = [
    "TILE_SIZE", "have_pyvips", "tile_image_array", "tile_origin",
    "save_and_tile", "divide_and_conquer", "crop_wsis",
    "merge_1536_subdirectories", "rename_temp_directories",
    "clear_1536_directory", "iter_wsi_tile_dirs",
]
