"""Overlap-aware union merging of same-class detections.

Counterpart of the reference package's ``ops/merge.py`` (host numpy, kept
as a copy of its own): ``mergeDetections`` / ``combineIfOverlapping`` /
``combineOverlappingBboxes`` of the original code (``core.py:277-423``).
The original tests overlap by materializing *every pixel* of both boxes into
Python sets (O(area) per pair!); the accept/reject decision is equivalent to
closed-interval intersection of the integer pixel grids, which is what we
compute:

* a box ``(x, y, w, h)`` covers pixels ``x .. x+w-1`` × ``y .. y+h-1``;
* two boxes overlap iff ``max(x1,x2) < min(x1+w1, x2+w2)`` and likewise in y
  (touching edges do NOT overlap; zero-area boxes never overlap);
* the merged box is the pixel-grid bounding union, which in the reference's
  (x, y, w, h) output convention **loses one pixel** of width/height
  (``furthest_right - furthest_left`` where ``furthest_right`` is the last
  covered pixel index — ``core.py:349-364``).  We reproduce that quirk
  exactly; box-for-box parity would otherwise drift by 1px per merge.

Merged detections keep ``min(conf)`` / ``min(cls_conf)`` of the pair
(``core.py:409``) and iteration continues to a fixed point because a merged
box can newly overlap others.  The reference iterates a ``set`` of float
tuples (hash order); we iterate in deterministic first-come order, which
selects the same final fixed point in all non-pathological cases and makes
results reproducible run-to-run.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def combine_if_overlapping(
    bbox1: Sequence[int], bbox2: Sequence[int]
) -> Tuple[bool, Optional[Tuple[int, int, int, int]]]:
    """Rectangle-math equivalent of ``combineIfOverlapping`` (``core.py:326-364``)."""
    x1, y1, w1, h1 = bbox1
    x2, y2, w2, h2 = bbox2
    if w1 <= 0 or h1 <= 0 or w2 <= 0 or h2 <= 0:
        return False, None
    if max(x1, x2) >= min(x1 + w1, x2 + w2):
        return False, None
    if max(y1, y2) >= min(y1 + h1, y2 + h2):
        return False, None
    left = min(x1, x2)
    top = min(y1, y2)
    right = max(x1 + w1, x2 + w2) - 1  # last covered pixel index (reference quirk)
    bottom = max(y1 + h1, y2 + h2) - 1
    return True, (left, top, right - left, bottom - top)


def merge_detections(detections: np.ndarray) -> np.ndarray:
    """Union-merge overlapping same-class detections to a fixed point.

    Parity: ``mergeDetections`` (``core.py:366-423``).  ``detections`` is
    (N, 7) rows ``(x1, y1, x2, y2, conf, cls_conf, cls_pred)`` in pixel
    space; returns the merged (M, 7) array.  Boxes are truncated to int for
    the overlap test and the merged output coordinates are integers, exactly
    as the reference's ``int()`` casts produce.
    """
    entries: List[Tuple[float, ...]] = [tuple(map(float, row)) for row in np.asarray(detections)]
    changed = True
    while changed:
        changed = False
        removed = [False] * len(entries)
        appended: List[Tuple[float, ...]] = []
        for i in range(len(entries)):
            if removed[i]:
                continue
            for j in range(i + 1, len(entries)):
                if removed[i] or removed[j]:
                    continue
                ei, ej = entries[i], entries[j]
                li, lj = ei[6], ej[6]
                if not ((li == 1 == lj) or (li == 0 == lj)):
                    continue
                bi = (int(ei[0]), int(ei[1]), int(ei[2] - ei[0]), int(ei[3] - ei[1]))
                bj = (int(ej[0]), int(ej[1]), int(ej[2] - ej[0]), int(ej[3] - ej[1]))
                ok, nb = combine_if_overlapping(bi, bj)
                if not ok:
                    continue
                new_entry = (
                    float(nb[0]), float(nb[1]),
                    float(nb[0] + nb[2]), float(nb[1] + nb[3]),
                    min(ei[4], ej[4]), min(ei[5], ej[5]), li,
                )
                if new_entry in entries or new_entry in appended:
                    continue  # reference skips duplicates (core.py:411)
                removed[i] = removed[j] = True
                appended.append(new_entry)
                changed = True
        entries = [e for k, e in enumerate(entries) if not removed[k]] + appended
    if not entries:
        return np.zeros((0, 7), np.float32)
    return np.asarray(entries, np.float32)


def combine_overlapping_bboxes(mapp: dict) -> dict:
    """Label-space merge for annotation maps.

    Parity: ``combineOverlappingBboxes`` (``core.py:277-324``) — values are
    lists of ``((x, y, w, h), (cored, diffuse, CAA))`` tuples; boxes merge
    when they overlap AND share a positive cored or CAA label.  Note the
    reference computes the combined label as ``label_i or label_j``, which
    for non-empty tuples is always ``label_i`` — the first box's label wins;
    reproduced as-is.
    """
    out = {}
    for img_name, pairs in mapp.items():
        entries = [(tuple(int(v) for v in b), tuple(l)) for b, l in pairs]
        changed = True
        while changed:
            changed = False
            removed = [False] * len(entries)
            appended: List[Tuple[tuple, tuple]] = []
            for i in range(len(entries)):
                if removed[i]:
                    continue
                for j in range(i + 1, len(entries)):
                    if removed[i] or removed[j]:
                        continue
                    (bi, lab_i), (bj, lab_j) = entries[i], entries[j]
                    if not ((lab_i[0] == 1 == lab_j[0]) or (lab_i[2] == 1 == lab_j[2])):
                        continue
                    ok, nb = combine_if_overlapping(bi, bj)
                    if not ok:
                        continue
                    new_entry = (nb, lab_i or lab_j)
                    if new_entry in entries or new_entry in appended:
                        continue
                    removed[i] = removed[j] = True
                    appended.append(new_entry)
                    changed = True
            entries = [e for k, e in enumerate(entries) if not removed[k]] + appended
        out[img_name] = entries
    return out


def merge_wsi_detections(
    dets_by_path: dict,
    origins: dict,
    tile_size: int = 1536,
):
    """Cross-tile overlap-aware merge over a whole WSI (new capability).

    The reference merges strictly within a tile (``core.py:366-423`` called
    per tile at ``validation.py:127-129``), so a plaque straddling two
    adjacent 1536² tiles is counted twice.  This pass lifts per-tile
    detections into slide space and merges same-class boxes *across* tile
    boundaries.

    Semantics (within-tile semantics are untouched — inputs are expected to
    be per-tile merged already):

    * boxes from **different** source tiles merge when their closed pixel
      rectangles overlap **or abut** (≤ 1px gap — a plaque split by a tile
      boundary produces boxes ending at column ``o-1`` and starting at
      ``o``, which touch but do not overlap);
    * the merged box is the exact pixel bounding union (the reference's
      −1px width quirk is an artifact of its (x,y,w,h) round trip and is
      NOT reproduced here — this pass has no reference counterpart);
    * merged confidences propagate ``min(conf)`` / ``min(cls_conf)``,
      matching the reference's within-tile rule (``core.py:409``);
    * iterated to a fixed point; a merged box carries the union of its
      source tiles and may chain across ≥3 tiles.  Two boxes whose source
      sets are identical never merge (that pair was already resolved by the
      within-tile pass).

    Args:
      dets_by_path: ``{tile_path: (N, 7) array or None}`` in TILE pixel
        coordinates, rows ``(x1, y1, x2, y2, conf, cls_conf, cls_pred)``.
      origins: ``{tile_path: (ox, oy) or None}`` slide-space tile origins;
        tiles with ``None`` origin do not participate (their rows pass
        through unmerged, keyed to their own tile).
      tile_size: tile edge length in pixels (box-center → owner-tile
        assignment for the per-tile counts).

    Returns:
      ``(rows, owners)`` — ``rows`` is an (M, 7) float32 array in SLIDE
      pixel coordinates; ``owners`` a length-M list of tile paths, each row
      assigned to the tile containing its center (guaranteed to be one of
      the row's source tiles).
    """
    entries = []  # [slide-space row(list of 7), frozenset(source paths)]
    passthrough_rows: List[np.ndarray] = []
    passthrough_owner: List[str] = []
    for path, dets in dets_by_path.items():
        if dets is None or len(dets) == 0:
            continue
        origin = origins.get(path)
        for row in np.asarray(dets, np.float32):
            if origin is None:
                passthrough_rows.append(row)
                passthrough_owner.append(path)
                continue
            ox, oy = origin
            shifted = row.copy()
            shifted[0] += ox
            shifted[1] += oy
            shifted[2] += ox
            shifted[3] += oy
            entries.append([shifted, frozenset([path])])

    # Fixed-point loop.  A dense slide can carry thousands of boxes; the
    # naive all-pairs scan is O(N²) per round, so candidate pairs come from
    # a spatial hash instead: every box is binned by its 1px-EXPANDED rect,
    # hence any overlap-or-abut pair shares at least one cell and the
    # candidate set is a superset of the qualifying set.  Candidates are
    # visited in the same ascending (i, then j>i) order as the all-pairs
    # loop, so the greedy-merge fixed point is IDENTICAL to the naive scan
    # (the reference package checks this against the naive scan).
    _CELL = 256
    changed = True
    while changed:
        changed = False
        removed = [False] * len(entries)
        appended = []
        grid: dict = {}
        spans = []
        for k, (r, _) in enumerate(entries):
            # same int() truncation as the pair predicate below, ±1px
            span = ((int(r[0]) - 1) // _CELL, (int(r[2]) + 1) // _CELL,
                    (int(r[1]) - 1) // _CELL, (int(r[3]) + 1) // _CELL)
            spans.append(span)
            for cx in range(span[0], span[1] + 1):
                for cy in range(span[2], span[3] + 1):
                    grid.setdefault((cx, cy), []).append(k)
        for i in range(len(entries)):
            if removed[i]:
                continue
            x0, x1, y0, y1 = spans[i]
            cand = set()
            for cx in range(x0, x1 + 1):
                for cy in range(y0, y1 + 1):
                    cand.update(grid.get((cx, cy), ()))
            for j in sorted(cand):
                if j <= i or removed[i] or removed[j]:
                    continue
                (ri, si), (rj, sj) = entries[i], entries[j]
                if ri[6] != rj[6] or si == sj:
                    continue
                # closed-rect overlap-or-abut (≤1px gap) in integer pixels
                if (max(int(ri[0]), int(rj[0])) > min(int(ri[2]), int(rj[2])) + 1
                        or max(int(ri[1]), int(rj[1])) > min(int(ri[3]), int(rj[3])) + 1):
                    continue
                merged = np.array([
                    min(ri[0], rj[0]), min(ri[1], rj[1]),
                    max(ri[2], rj[2]), max(ri[3], rj[3]),
                    min(ri[4], rj[4]), min(ri[5], rj[5]), ri[6],
                ], np.float32)
                removed[i] = removed[j] = True
                appended.append([merged, si | sj])
                changed = True
        entries = [e for k, e in enumerate(entries) if not removed[k]] + appended

    rows: List[np.ndarray] = []
    owners: List[str] = []
    for row, sources in entries:
        cx = (row[0] + row[2]) / 2.0
        cy = (row[1] + row[3]) / 2.0
        # owner = source tile whose slide-space footprint contains the
        # center (clamped to the nearest source when the center rounds out)
        best, best_d = None, None
        for p in sources:
            ox, oy = origins[p]
            dx = max(ox - cx, 0.0, cx - (ox + tile_size - 1))
            dy = max(oy - cy, 0.0, cy - (oy + tile_size - 1))
            d = dx * dx + dy * dy
            if best is None or d < best_d:
                best, best_d = p, d
        rows.append(row)
        owners.append(best)
    rows.extend(passthrough_rows)
    owners.extend(passthrough_owner)
    if not rows:
        return np.zeros((0, 7), np.float32), []
    return np.stack(rows).astype(np.float32), owners


__all__ = ["combine_if_overlapping", "merge_detections",
           "combine_overlapping_bboxes", "merge_wsi_detections"]
