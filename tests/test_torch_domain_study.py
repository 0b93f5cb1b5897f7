"""The port's study metrics and weak-label helpers (``domain.py``) against
the JAX package's: ``iou_xyxy``/``IOU``, ``get_accuracy`` and ``get_tps``
on the cases of ``tests/test_domain.py`` and on seeded random ones, the
filter map, ``pre_process`` with and without weak labels,
``seed_folder_from_list``, ``compare_premerge_with_postmerge`` and
``device_memory_stats``.

Tolerances: the metrics, the maps and the files written are exactly equal;
the weak labels' CAA probabilities agree within 1e-5 (one classifier, run
by each package in float32).
"""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu import domain as jax_domain
from amyloid_yolo_tpu_torch import domain
from amyloid_yolo_tpu_torch.models import classifier

from torch_port_helpers import jax_classifier_params, stain_tile

PROB_ATOL = 1e-5

IOU_CASES = [
    ([100, 100, 200, 200], [100, 100, 200, 200]),
    ([100, 100, 200, 200], [201, 201, 300, 300]),
    ([100, 100, 200, 200], [150, 150, 200, 200]),
    ([0.5, 1.25, 30.0, 40.5], [10.0, 5.0, 25.5, 60.0]),
    ([10, 10, 10, 10], [10, 10, 10, 10]),
]


@pytest.mark.parametrize("a,b", IOU_CASES)
def test_iou_matches_jax(a, b):
    got = domain.iou_xyxy(a, b)
    assert got == jax_domain.iou_xyxy(a, b) == domain.IOU(a, b) == jax_domain.IOU(b, a)


def test_iou_reference_cases():
    assert domain.IOU([100, 100, 200, 200], [100, 100, 200, 200]) == 1
    assert domain.IOU([100, 100, 200, 200], [201, 201, 300, 300]) == 0
    assert 0.25 <= domain.IOU([100, 100, 200, 200], [150, 150, 200, 200]) <= 0.26


@pytest.mark.parametrize("l1,l2,want", [([0, 0, 0], [1, 1, 1], 0), ([1, 1, 1], [1, 1, 1], 1),
                                        ([0, 1, 0], [1, 1, 1], 1 / 3),
                                        (["a", "b"], ["a", "c"], 0.5)])
def test_get_accuracy_matches_jax(l1, l2, want):
    assert domain.get_accuracy(l1, l2) == jax_domain.get_accuracy(l1, l2) == want


_P = [[100, 100, 200, 200, 0.9, 0], [201, 201, 300, 300, 0.9, 1]]
_L = [[100, 100, 200, 200, 0], [201, 201, 300, 300, 1]]
_TIE = [[100, 100, 200, 200, 0.9, 0], [100, 100, 200, 200, 0.9, 0]]
TPS_CASES = {
    "reference": (_P, _L, [1, 1]),
    "order": ([_P[1], _P[0]], _L, [1, 1]),
    "class_mismatch": ([[100, 100, 200, 200, 0.9, 1], [201, 201, 300, 300, 0.9, 0]], _L, [0, 0]),
    "iou_below": (_P, [[150, 150, 160, 160, 0], [201, 201, 203, 203, 1]], [0, 0]),
    "no_double_dipping": ([[100, 100, 200, 200, 0.5, 0], [100, 100, 200, 200, 0.9, 0]],
                          [[100, 100, 200, 200, 0]], [0, 1]),
    "tie_later_row_wins": (_TIE, [[100, 100, 200, 200, 0]], [0, 1]),
    "three_way_tie": (_TIE + [[100, 100, 200, 200, 0.9, 0]], [[100, 100, 200, 200, 0]],
                      [0, 0, 1]),
    "tie_distinct_labels": (_TIE, [[100, 100, 200, 200, 0], [101, 101, 201, 201, 0]], [1, 1]),
    "value_equal_labels_collide": (_TIE, [[100, 100, 200, 200, 0], [100, 100, 200, 200, 0]],
                                   [0, 1]),
}


@pytest.mark.parametrize("name", sorted(TPS_CASES))
def test_get_tps_reference_cases_match_jax(name):
    preds, labels, want = TPS_CASES[name]
    got = domain.get_tps(preds, labels, 0.5)
    assert got == jax_domain.get_tps(preds, labels, 0.5) == want
    assert domain.get_tps(preds, labels, 0.5, pascal_voc_scheme=False) == \
        jax_domain.get_tps(preds, labels, 0.5, pascal_voc_scheme=False)


def _random_rows(rng, n, with_conf: bool):
    xy = rng.randint(0, 300, (n, 2))
    wh = rng.randint(5, 80, (n, 2))
    cls = rng.randint(0, 2, (n, 1))
    if with_conf:  # one decimal: many ties
        conf = np.round(rng.rand(n, 2), 1)
        return np.concatenate([xy, xy + wh, conf, cls], axis=1).tolist()
    return np.concatenate([xy, xy + wh, cls], axis=1).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_get_tps_random_flags_equal(seed):
    rng = np.random.RandomState(seed)
    labels = _random_rows(rng, 15, with_conf=False)
    labels += labels[:3]  # value-equal duplicates
    preds = _random_rows(rng, 40, with_conf=True)
    # predictions on top of labels, jittered, so some are TPs
    for lab in labels[:10]:
        j = rng.randint(-6, 7, 4)
        preds.append([lab[0] + j[0], lab[1] + j[1], lab[2] + j[2], lab[3] + j[3],
                      float(np.round(rng.rand(), 1)), 0.5, lab[4]])
    for t in (0.1, 0.5, 0.9):
        for voc in (True, False):
            got = domain.get_tps(preds, labels, t, pascal_voc_scheme=voc)
            assert got == jax_domain.get_tps(preds, labels, t, pascal_voc_scheme=voc)
    assert 0 < sum(domain.get_tps(preds, labels, 0.5)) < len(preds)


_MAPP = {
    "a": [((0, 0, 1, 1), (1, 0, 0))],
    "b": [((0, 0, 1, 1), (0, 0, 1))],
    "c": [((0, 0, 1, 1), (0, 1, 0))],
    "d": [((0, 0, 1, 1), (0.2, 0.9, 0.1)), ((5, 5, 2, 2), (0.7, 0.1, 0.6))],
}


@pytest.mark.parametrize("just_caa,just_cored,want", [
    (False, False, {"a", "b", "d"}), (True, False, {"b", "d"}), (False, True, {"a", "d"}),
    (True, True, {"a", "b", "d"})])
def test_filter_map_matches_jax(just_caa, just_cored, want):
    got = domain.filter_map_to_get_cored_or_caa(_MAPP, just_CAA=just_caa, just_Cored=just_cored)
    assert got == jax_domain.filter_map_to_get_cored_or_caa(
        _MAPP, just_CAA=just_caa, just_Cored=just_cored)
    assert set(got) == want


# -- pre_process: the weak-label map from two CSVs ------------------------------

@pytest.fixture(scope="module")
def study_csvs(tmp_path_factory):
    """An image-details CSV of 10 boxes on 3 tiles and a consensus CSV that
    labels 4 of them; the tiles are 512² stain JPEGs under ``images/``."""
    import pandas as pd

    root = tmp_path_factory.mktemp("preprocess")
    images = root / "images"
    images.mkdir()
    rng = np.random.RandomState(11)
    tiles = [("wsiA", 0, 1), ("wsiA", 2, 3), ("wsiB", 1, 0)]
    for src, r, c in tiles:
        Image.fromarray(stain_tile(rng, 512, 512)).save(images / f"{src}_0_{r}_{c}.jpg",
                                                        quality=90)
    details, consensus = [], []
    for k in range(10):
        src, r, c = tiles[k % 3]
        x, y = rng.randint(0, 480, 2)
        w, h = rng.randint(8, 120, 2)
        name = f"{src}/blob_{k}.jpg"
        details.append({"imagename": name, "source": src, "tile_row": r, "tile_column": c,
                        "blob coordinates (xywh)": f"[ {x}  {y} {w} {h}]"})
        if k % 3 == 1 or k == 9:
            consensus.append({"imagename": f"prefix/{name}", "cored": k % 2,
                              "diffuse": 1, "CAA": 1 - k % 2})
    pd.DataFrame(details).to_csv(root / "details.csv", index=False)
    pd.DataFrame(consensus).to_csv(root / "consensus.csv", index=False)
    return root


@pytest.fixture(scope="module")
def caa_params():
    return jax_classifier_params(3, fc_scale=8.0, jit=True)


@pytest.mark.parametrize("weak_label", [False, True])
def test_pre_process_matches_jax(study_csvs, caa_params, weak_label):
    args = (str(study_csvs / "details.csv"), str(study_csvs / "consensus.csv"))
    images_dir = str(study_csvs / "images") + "/"
    got = domain.pre_process(
        *args, images_dir=images_dir, weak_label=weak_label,
        caa_filter=domain.CAAFilter(classifier.from_jax_params(caa_params), device="cpu"))
    want = jax_domain.pre_process(*args, images_dir=images_dir, weak_label=weak_label,
                                  caa_filter=jax_domain.CAAFilter(caa_params))
    assert list(got) == list(want)
    n_rows = sum(len(v) for v in got.values())
    assert n_rows == (10 if weak_label else 4)
    for k in want:
        assert len(got[k]) == len(want[k])
        for (gb, gl), (wb, wl) in zip(got[k], want[k]):
            assert gb == wb
            if all(isinstance(v, int) for v in wl):  # a human label: exact
                assert gl == wl
            else:
                np.testing.assert_allclose(gl, wl, rtol=0, atol=PROB_ATOL)
    if weak_label:
        probs = [l for v in got.values() for _, l in v if not isinstance(l[0], int)]
        assert len(probs) == 6 and all(0.0 <= p <= 1.0 for l in probs for p in l)


def test_seed_folder_from_list_copies_the_same_files(tmp_path):
    rng = np.random.RandomState(2)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"src_{i}.jpg"))
        Image.fromarray(stain_tile(rng, 64, 64)).save(paths[-1], quality=90)
    (tmp_path / "list.txt").write_text("\n".join(paths) + "\n\n")
    for side, mod in (("p", domain), ("j", jax_domain)):
        dest = tmp_path / side
        dest.mkdir()
        (dest / "stale.jpg").write_bytes(b"x")  # the folder is made anew
        mod.seed_folder_from_list(str(tmp_path / "list.txt"), str(dest))
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == [f"src_{i}.jpg" for i in range(3)]
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_compare_premerge_with_postmerge_writes_the_same_images(tmp_path):
    rng = np.random.RandomState(5)
    src = tmp_path / "tiles"
    src.mkdir()
    pre, post = {}, {}
    for i in range(4):
        p = str(src / f"t{i}.jpg")
        Image.fromarray(stain_tile(rng, 128, 128)).save(p, quality=90)
        boxes = [[int(v) for v in rng.randint(0, 100, 2)] + [20, 24] for _ in range(3)]
        labels = [(0, 1, 1), (1, 0, 0), (0, 0, 1 if i != 2 else 0)]
        pre[p] = list(zip(boxes, labels))
        post[p] = pre[p][:2]
    for side, mod in (("p", domain), ("j", jax_domain)):
        mod.compare_premerge_with_postmerge(pre, post, output_dir=str(tmp_path / side),
                                           sample_size=3, seed=1)
    for sub in ("premerge", "postmerge"):
        names = sorted(os.listdir(tmp_path / "p" / sub))
        assert names == sorted(os.listdir(tmp_path / "j" / sub)) and len(names) == 3
        for n in names:
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p" / sub / n)),
                                          np.asarray(Image.open(tmp_path / "j" / sub / n)))
    shutil.rmtree(tmp_path / "p")


def test_device_memory_stats_on_the_cpu_matches_jax():
    want = jax_domain.device_memory_stats()
    assert domain.device_memory_stats(["cpu"] * len(jax.devices())) == want
    assert domain.device_memory_stats([torch.device("cpu")]) == {
        0: {"bytes_in_use": 0, "bytes_limit": 0}}


def test_device_memory_stats_needs_a_card_or_explicit_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        domain.device_memory_stats()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        domain.device_memory_stats(["cuda:0"])


def test_all_matches_jax():
    assert sorted(domain.__all__) == sorted(jax_domain.__all__)
