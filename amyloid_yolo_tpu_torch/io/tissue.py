"""Background-tile suppression before decode (``detect_folder(
background_skip=True)``).

Counterpart of the reference package's ``io/tissue.py`` (host numpy and PIL,
kept as a copy of its own); the original code sweeps every tile and has no
such pass.  Real slides are mostly background, and a background tile costs
a full JPEG decode like any other, so :func:`prefilter_tile_paths` drops it
first, in two stages:

* stage 1 is the JPEG **file size** (one ``stat``): blank 1536² tiles
  encode at ~0.016 bytes/pixel, stained tissue at several times more;
* stage 2 confirms each small file by decoding it at 1/8 DCT scale (PIL
  ``draft``) and measuring :func:`tissue_fraction`.  Only the small, cheap
  files pay for it, and a faint tissue tile that is small on disk is kept.

A pixel is background iff ``min(R,G,B) > 200`` and its chroma
(``max - min``) ``< 24``: slide glass is bright and unsaturated, stained
tissue is not.  A tile is skipped only when BOTH stages call it background.
The thresholds are the reference's, gated there on real prospective tiles.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

#: stage-1 candidate threshold, bytes per pixel of encoded JPEG.  Blank /
#: near-blank tiles encode at ≤ ~0.03 bpp at Q90; the gated default 0.05
#: admits some true-background tiles into the (cheap) confirm stage rather
#: than risking a skip on size alone.  Tissue tiles measure ≥ 0.11 bpp
#: (min of the 200 real tiles is 0.017 — a mostly-background corner tile
#: that stage 2 correctly KEEPS because its fraction is 0.037 ≥ 0.02).
BACKGROUND_MAX_BPP = 0.05

#: stage-2 skip threshold: fraction of (subsampled) pixels that look like
#: tissue.  0.02 of a 1536² tile is ≈ 47k px ≈ a 217² patch — far larger
#: than any annotated plaque crop; the gate validates empirically.
TISSUE_MIN_FRACTION = 0.02

#: background pixel definition (uint8): bright AND unsaturated
BG_MIN_BRIGHTNESS = 200
BG_MAX_CHROMA = 24


def tissue_fraction(img: np.ndarray, subsample: int = 4) -> float:
    """Fraction of pixels that look like stained tissue (HWC uint8 RGB).

    ``subsample`` strides both axes (default 4: 1/16 of the pixels — the
    statistic is area-scale, insensitive to stride).
    """
    px = img[::subsample, ::subsample].astype(np.int16)
    mn = px.min(axis=-1)
    mx = px.max(axis=-1)
    background = (mn > BG_MIN_BRIGHTNESS) & ((mx - mn) < BG_MAX_CHROMA)
    return float(1.0 - background.mean())


def is_background_file(
    path: str,
    max_bpp: float = BACKGROUND_MAX_BPP,
    min_tissue: float = TISSUE_MIN_FRACTION,
    confirm_scale: int = 8,
) -> bool:
    """Two-stage background test for one encoded tile.

    Stage 1 (free): files at or above ``max_bpp`` bytes/pixel are tissue,
    full stop — no decode.  Stage 2 (cheap, only for small files): decode
    at 1/``confirm_scale`` DCT scale and skip only if
    :func:`tissue_fraction` < ``min_tissue``.  Unreadable files return
    False (NOT background — let the pipeline surface the error its usual
    way).
    """
    try:
        size = os.path.getsize(path)
        from PIL import Image

        with Image.open(path) as im:
            w, h = im.size
            if size >= max_bpp * w * h:
                return False
            # stage 2: DCT-scaled decode (libjpeg draft mode); cost scales
            # with the compressed size, i.e. smallest for true background
            im.draft("RGB", (max(1, w // confirm_scale),
                             max(1, h // confirm_scale)))
            arr = np.asarray(im.convert("RGB"))
        return tissue_fraction(arr, subsample=1) < min_tissue
    except Exception:
        return False


def prefilter_tile_paths(
    paths: Sequence[str],
    max_bpp: float = BACKGROUND_MAX_BPP,
    min_tissue: float = TISSUE_MIN_FRACTION,
) -> Tuple[List[str], List[str]]:
    """Split tile paths into (kept, skipped_background).

    The sweep-time background prefilter: stat every file, confirm-decode
    only the small ones (see module docstring for why that ordering makes
    the filter ~free on tissue-dominated folders and maximally profitable
    on background-dominated ones).
    """
    kept: List[str] = []
    skipped: List[str] = []
    for p in paths:
        (skipped if is_background_file(p, max_bpp, min_tissue) else kept).append(p)
    return kept, skipped


__all__ = [
    "BACKGROUND_MAX_BPP", "TISSUE_MIN_FRACTION", "BG_MIN_BRIGHTNESS",
    "BG_MAX_CHROMA", "tissue_fraction", "is_background_file",
    "prefilter_tile_paths",
]
