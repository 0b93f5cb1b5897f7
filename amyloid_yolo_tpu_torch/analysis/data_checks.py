"""Checks of the study data, the original's data-dependent tests.

Counterpart of the reference package's ``analysis/data_checks.py``: the
original ``unit_test.py``'s ``DataSetTests`` (``unit_test.py:31-131``) and
its benchmark checks assert invariants of the study's own data (train and
valid splits disjoint and equal across the training phases, the
prospective set's make-up).  That data is distributed apart from the code,
so the checks are functions, to run wherever the data lives; each raises
``AssertionError`` when its invariant fails.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List


def _read_list(path: str) -> List[str]:
    with open(path) as fh:
        return [ln.strip() for ln in fh.read().splitlines() if ln.strip()]


def check_train_valid_disjoint(train_txt: str, valid_txt: str) -> None:
    """``testTrainingTestSplit`` (``unit_test.py:35-54``)."""
    train = set(_read_list(train_txt))
    valid = set(_read_list(valid_txt))
    overlap = train & valid
    if overlap:
        raise AssertionError(f"train/valid overlap: {sorted(overlap)[:5]} ...")


def check_split_identity_across_phases(dir_a: str, dir_b: str) -> None:
    """``testTrainValidConsistencyForBothTrainingIterations``
    (``unit_test.py:56-83``): phase-1 and phase-2 splits must be identical."""
    for name in ("train.txt", "valid.txt"):
        a = set(_read_list(os.path.join(dir_a, name)))
        b = set(_read_list(os.path.join(dir_b, name)))
        if a != b:
            raise AssertionError(f"{name} differs between {dir_a} and {dir_b}")


def check_prospective_composition(csv_path: str) -> None:
    """``testValidationImages`` (``unit_test.py:85-123``): 56 WSIs, 96+96
    class-enriched tiles, 144 model- vs 48 human-enriched, 50 per stain."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    wsis = set()
    for field in df["Image Name"]:
        start = field.find("data/MRPI_tiles/") + 16
        wsi = ""
        for ch in field[start:]:
            if ch == "/":
                break
            wsi += ch
        wsis.add(wsi)
    assert len(wsis) == 56, f"expected 56 WSIs, got {len(wsis)}"
    assert len(df["Image Name"]) == len(set(df["Image Name"])), "duplicate images"
    classes = list(df["Amyloid Class"])
    assert classes.count("CAA") == classes.count("Cored") == 96
    sel = list(df["Selected by"])
    assert sel.count("Model") == 144 and sel.count("Human") == 48
    stains = list(df["Stain"])
    for stain in ("4G8", "6E10", "ABeta40", "ABeta42"):
        assert stains.count(stain) == 50, f"stain {stain}: {stains.count(stain)}"


def check_preprocess_against_golden(mapp: Dict, golden_pickle: str) -> None:
    """``testPreprocess`` (``unit_test.py:125-131``): the weak-label map must
    equal the stored golden artifact."""
    with open(golden_pickle, "rb") as fh:
        golden = pickle.load(fh)
    assert mapp == golden, "preprocess output differs from golden pickle"


def check_consensus_subset_of_annotators(consensus: Dict,
                                         annotations_by_np: Dict[str, Dict]) -> None:
    """``testConsensusBenchmark`` (``unit_test.py:191-205``): every consensus
    entry must appear verbatim in some annotator's set."""
    union: Dict[str, list] = {}
    for ann in annotations_by_np.values():
        for img, entries in ann.items():
            union.setdefault(img, [])
            union[img] += entries
    for img, entries in consensus.items():
        for tup in entries:
            assert tup in union.get(img, []), f"consensus entry not found: {img} {tup}"


def check_interrater_precision_bounds(precision_dict: Dict) -> None:
    """``testAnnotatorsRelativeToEachOtherBenchmark`` (``unit_test.py:207-225``):
    published sanity envelopes on mean pairwise precision."""
    import numpy as np

    annotators = [f"NP{i}" for i in range(1, 5)]
    buckets = {("Cored", 0.5): [], ("CAA", 0.5): [], ("Cored", 0.1): [], ("CAA", 0.1): []}
    for a1 in annotators:
        for a2 in annotators:
            if a1 == a2:
                continue
            for (cls, t) in buckets:
                buckets[(cls, t)].append(precision_dict[cls][a1][a2][t])
    assert 0.6 < np.mean(buckets[("Cored", 0.5)]) < 0.7
    assert 0.5 < np.mean(buckets[("CAA", 0.5)]) < 0.6
    assert 0.6 < np.mean(buckets[("Cored", 0.1)]) < 0.7
    assert 0.6 < np.mean(buckets[("CAA", 0.1)]) < 0.65


def check_precision_map_empties(precision_img_map: Dict[str, float],
                                predictions: Dict[str, list],
                                amyloid_class: str) -> None:
    """``testPrecisionMapEmpties`` (``unit_test.py:227-241``): precision -1
    images truly have no prediction of that class."""
    for img, val in precision_img_map.items():
        if val != -1:
            continue
        for entry in predictions.get(img, []):
            assert entry[1] != amyloid_class, f"{img} has a {amyloid_class} prediction"


__all__ = [
    "check_train_valid_disjoint", "check_split_identity_across_phases",
    "check_prospective_composition", "check_preprocess_against_golden",
    "check_consensus_subset_of_annotators", "check_interrater_precision_bounds",
    "check_precision_map_empties",
]
