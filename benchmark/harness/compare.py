"""The numbers that decide ``correct``, each held against its limit.

Detection (what the timed calls returned, against the reference on the
same tiles; :func:`detect_numbers`).  Which rows pass the objectness
threshold, which survive the NMS and which class wins are decisions that
rounding flips near their thresholds, so each program keeper is held to the
reference row that agrees with it best, and a reference keeper counts as
missed by how far it lay above the threshold:

* ``conf_gap``: over the program's keepers, the widest gap to the closest
  reference row at its place: the least, over the reference's rows with
  IoU ≥ 0.5 against the keeper's box and objectness ≥ ``conf_thres`` −
  0.1, of the larger of the objectness gap and the gap of the keeper's
  class probability; a keeper with no such row reads 1;
* ``miss_margin``: over the reference's keepers that no program keeper
  overlaps with IoU ≥ 0.3, the widest margin of objectness above
  ``conf_thres`` (0 when there is none);
* ``box_gap``: over the pairs of a program keeper and a reference keeper
  (same class, IoU ≥ 0.5, best IoU first), the median ``1 − IoU``: the
  decode's width and height, the NMS's confidence-weighted merge and the
  rescale to tile pixels, which the two numbers above hold only to IoU
  0.5 and 0.3.  Not the widest, nor the 99th percentile: a row near the
  threshold that joins one side's merge and not the other's, or two rows
  of near-equal score that lead their merge in the other order, move that
  merged box far, so both swing from seed to seed on sound runs; a fault
  in the decode or the rescale moves every pair.

The candidate counts, the share of keepers without a same-class partner
and the count of tiles compared are reported beside them, not compared.

Training (the first three micro-steps, against the reference's;
:func:`train_numbers`), each leaf's gap a gap of norms, taken against the
reference's norm of that leaf or of the median leaf, whichever is larger:

* ``loss_gap``: the widest relative gap of the three losses;
* ``grad_gap``: the worst leaf of the first gradient, as Adam got it;
* ``change_gap``: the worst leaf of the parameters' change over the three
  steps, leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (they move under Adam by round-off);
* ``stats_gap``: the worst leaf of the BN running statistics' change.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MATCH_IOU = 0.5
MISS_IOU = 0.3
ROW_SLACK = 0.1
GRAD_FLOOR = 1e-3


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def match(p: np.ndarray, r: np.ndarray) -> List[Tuple[int, int]]:
    """Greedy pairs of rows of ``p`` and ``r`` (x1 y1 x2 y2 conf cls_conf
    cls): same class, IoU ≥ :data:`MATCH_IOU`, best IoU first."""
    if not len(p) or not len(r):
        return []
    iou = _iou_matrix(p, r)
    iou[p[:, None, 6] != r[None, :, 6]] = -1.0
    pairs, used_p, used_r = [], set(), set()
    for flat in np.argsort(-iou, axis=None, kind="stable"):
        i, j = divmod(int(flat), iou.shape[1])
        if iou[i, j] < MATCH_IOU:
            break
        if i not in used_p and j not in used_r:
            pairs.append((i, j))
            used_p.add(i)
            used_r.add(j)
    return pairs


def detect_numbers(program: Sequence[Tuple[np.ndarray, int]],
                   reference: Sequence[Tuple[np.ndarray, int, np.ndarray]],
                   conf_thres: float) -> Tuple[Dict[str, float], Dict[str, float]]:
    """``(numbers, diagnostics)``.  ``program``: per tile ``(keepers (k, 7)
    as x1 y1 x2 y2 conf cls_conf cls, candidate count)``; ``reference``:
    per tile ``(keepers, candidate count, rows (n, 5 + C))``, the tiles in
    the same order, boxes in tile pixels."""
    floor = conf_thres - ROW_SLACK
    conf_gap = miss = 0.0
    cand_diff = cand_ref = keepers = unmatched = 0
    pair_gaps = [np.zeros(0)]
    for (p, n_p), (r, n_r, rows) in zip(program, reference):
        cand_diff += abs(int(n_p) - int(n_r))
        cand_ref += int(n_r)
        pairs = match(p, r)
        if pairs:
            i, j = (np.array(x) for x in zip(*pairs))
            pair_gaps.append(1.0 - np.diag(_iou_matrix(p[i, :4], r[j, :4])))
        keepers += len(p) + len(r)
        unmatched += len(p) + len(r) - 2 * len(pairs)
        if len(p):
            near = rows[rows[:, 4] >= floor]
            gap = np.ones(len(p))
            if len(near):
                iou = _iou_matrix(p[:, :4], near[:, :4])
                cls = p[:, 6].astype(np.int64)
                g = np.maximum(np.abs(p[:, None, 4] - near[None, :, 4]),
                               np.abs(p[:, None, 5] - near[:, 5 + cls].T))
                g = np.where(iou >= MATCH_IOU, g, 1.0)
                gap = g.min(axis=1)
            conf_gap = max(conf_gap, float(gap.max()))
        if len(r):
            covered = (_iou_matrix(r[:, :4], p[:, :4]).max(axis=1) >= MISS_IOU
                       if len(p) else np.zeros(len(r), bool))
            if (~covered).any():
                miss = max(miss, float((r[~covered, 4] - conf_thres).max()))
    gaps = np.concatenate(pair_gaps)
    numbers = {"conf_gap": conf_gap, "miss_margin": max(miss, 0.0),
               "box_gap": float(np.median(gaps)) if len(gaps) else 0.0}
    diagnostics = {"cand_gap": cand_diff / max(cand_ref, 1),
                   "keeper_miss": unmatched / max(keepers, 1), "tiles": len(program),
                   "box_pairs": len(gaps),
                   "box_gap_widest": float(gaps.max()) if len(gaps) else 0.0,
                   "box_gap_p99": float(np.quantile(gaps, 0.99)) if len(gaps) else 0.0}
    return numbers, diagnostics


def _worst_leaf(got: Dict[str, float], want: Dict[str, float], keys) -> Tuple[float, str]:
    """The worst leaf's gap and its name."""
    keys = list(keys)
    if not keys:
        return 0.0, ""
    med = float(np.median([want[k] for k in keys]))
    return max((abs(got[k] - want[k]) / max(want[k], med, 1e-30), k) for k in keys)


def train_numbers(program: dict, reference: dict
                  ) -> Tuple[Dict[str, float], Dict[str, object]]:
    """``(numbers, diagnostics)``.  Each side: ``losses`` (three floats),
    ``grad`` (leaf → norm of the first gradient), ``change`` (leaf → norm
    of the change over the three steps), ``stats`` (BN statistic → norm of
    its change)."""
    lp, lr = program["losses"], reference["losses"]
    grad_ref = reference["grad"]
    med_grad = float(np.median(list(grad_ref.values())))
    moved = [k for k in reference["change"] if grad_ref[k] >= GRAD_FLOOR * med_grad]
    worst = {"grad_gap": _worst_leaf(program["grad"], grad_ref, grad_ref),
             "change_gap": _worst_leaf(program["change"], reference["change"], moved),
             "stats_gap": _worst_leaf(program["stats"], reference["stats"],
                                      reference["stats"])}
    numbers = {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, lr))}
    numbers.update({k: v for k, (v, _) in worst.items()})
    diagnostics = {"worst_leaf": {k: name for k, (_, name) in worst.items()},
                   "leaves_left_out": len(reference["change"]) - len(moved)}
    return numbers, diagnostics


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit; a number without a limit, or one that
    is not finite, fails."""
    return all(k in limits and np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
