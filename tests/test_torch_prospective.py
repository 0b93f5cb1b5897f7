"""The port's prospective study (``analysis/prospective.py``) against the
JAX package's, and the study as a whole.

The slice as a whole: the same synthetic tiles go through each package's
``run_model_on_validation_images`` (``Detector.detect_folder`` with the
merge and the CAA filter on, the mini graph in float32): the same images,
classes and row counts, boxes within ``BOX_ATOL`` px and scores within
``SCORE_ATOL`` (the bounds of ``test_detections_match_jax_detector``).

The analysis then runs in both packages on the JAX package's predictions,
so that a near-tie in confidence (the two pipelines differ by ~3e-5 in
score) cannot flip a TP flag and hide a fault: the benchmarks, the PRC
tables (``pandas.testing.assert_frame_equal``, exact), their CSV files,
the precision-map pickles, the AP maps, the interrater maps (NaN equal to
NaN), the relative precisions and the low-performance images are exactly
equal.
"""

import math
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.analysis import prospective as jax_P
from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.domain import CAAFilter as JaxCAAFilter
from amyloid_yolo_tpu_torch.analysis import prospective as P
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.domain import CAAFilter
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import classifier

from minispec import mini_spec
from torch_port_helpers import (jax_classifier_params, jax_params_np, low_dpi_figures,
                                port_mini_spec, write_tile_folder)

BOX_ATOL = 0.1
SCORE_ATOL = 1e-3
CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)
IOUS = [round(t, 2) for t in np.arange(0.1, 1.0, 0.1)]


@pytest.fixture(autouse=True)
def _low_dpi(monkeypatch):
    low_dpi_figures(monkeypatch)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Both packages' ``run_model_on_validation_images`` over one folder:
    (folder, port predictions, JAX predictions, pickle dir)."""
    root = tmp_path_factory.mktemp("prospective")
    folder = str(root / "images")
    write_tile_folder(folder, np.random.RandomState(3), 5, 256, border=(160, 256), blank=1)
    params = jax_params_np(mini_spec(), 4, jit=True)
    cparams = jax_classifier_params(3, fc_scale=8.0, jit=True)
    spec = port_mini_spec()
    det = Detector(spec, params_from_jax(params, spec), device="cpu",
                   compute_dtype=torch.float32, **CFG)
    jdet = JaxDetector(mini_spec(), params, compute_dtype=jnp.float32, **CFG)
    caa = CAAFilter(classifier.from_jax_params(cparams), device="cpu")
    got = P.run_model_on_validation_images(det, folder, str(root / "p" / "preds.pkl"),
                                           caa_filter=caa, merge=True, batch_size=4)
    want = jax_P.run_model_on_validation_images(jdet, folder, str(root / "j" / "preds.pkl"),
                                                caa_filter=JaxCAAFilter(cparams), merge=True,
                                                batch_size=4)
    return folder, got, want, root


def test_predictions_match_jax(slice_run):
    folder, got, want, root = slice_run
    assert list(got) == list(want)
    assert sorted(got) == sorted(set(os.listdir(folder)) - {"c_bad.jpg"})
    n_rows = 0
    for k in want:
        assert len(got[k]) == len(want[k]), k
        for (gd, gc), (wd, wc) in zip(got[k], want[k]):
            assert gc == wc and list(gd) == list(wd)
            assert gd["cls_pred"] == wd["cls_pred"]
            for key in ("x1", "y1", "x2", "y2"):
                assert abs(gd[key] - wd[key]) <= BOX_ATOL, (k, key)
            for key in ("conf", "cls_conf"):
                assert abs(gd[key] - wd[key]) <= SCORE_ATOL, (k, key)
        n_rows += len(got[k])
    classes = {c for v in got.values() for _, c in v}
    assert n_rows >= 5 and classes == {"CAA", "Cored"}
    with open(root / "p" / "preds.pkl", "rb") as fh:
        assert pickle.load(fh) == got


def _annotators(preds, seed: int = 0):
    """NP1: the predictions of half the images, exactly; NP2: NP1 jittered
    by <= 2 px; NP3: NP1 with one box of each image dropped and a stray box
    added; NP4: empty on two images."""
    rng = np.random.RandomState(seed)
    names = sorted(preds)
    np1 = {n: [({k: d[k] for k in ("x1", "y1", "x2", "y2")}, c) for d, c in preds[n]]
           for n in names[: len(names) // 2 + 1]}
    for n in names[len(names) // 2 + 1:]:
        np1[n] = []
    np2 = {n: [({k: v + int(rng.randint(-2, 3)) for k, v in d.items()}, c) for d, c in e]
           for n, e in np1.items()}
    np3 = {n: e[1:] + [({"x1": 10, "y1": 10, "x2": 60, "y2": 70}, "CAA")]
           for n, e in np1.items()}
    np4 = {n: ([] if i < 2 else list(reversed(e))) for i, (n, e) in enumerate(np2.items())}
    return {"NP1": np1, "NP2": np2, "NP3": np3, "NP4": np4}


@pytest.fixture(scope="module")
def study(slice_run):
    """The analysis inputs: the JAX predictions and four annotator sets."""
    want = slice_run[2]
    return want, _annotators(want)


@pytest.mark.parametrize("benchmark,t", [("consensus", t) for t in (0.1, 0.5, 0.9)]
                         + [("merged", 0.5)])
def test_benchmarks_match_jax(study, benchmark, t):
    _, by_np = study
    got = P.create_merged_or_consensus_benchmark(by_np, benchmark, t)
    assert got == jax_P.create_merged_or_consensus_benchmark(by_np, benchmark, t)
    assert sum(len(v) for v in got.values()) > 0


@pytest.fixture(scope="module")
def prc(study, tmp_path_factory):
    """PRC tables of both packages at IoU 0.1-0.9 for the consensus and the
    four annotators: (frames by side, root)."""
    preds, by_np = study
    root = tmp_path_factory.mktemp("prc")
    frames = {"p": {}, "j": {}}
    for annotator in ["consensus"] + sorted(by_np):
        for t in IOUS:
            ann = (jax_P.create_merged_or_consensus_benchmark(by_np, "consensus", t)
                   if annotator == "consensus" else by_np[annotator])
            for side, mod in (("p", P), ("j", jax_P)):
                frames[side][(annotator, t)] = mod.compare_annotations_to_predictions(
                    ann, preds, t, annotator, "prospective", prc_dir=str(root / side / "PRC"),
                    precision_maps_dir=str(root / side / "maps"))
    return frames, root


def test_prc_tables_match_jax(prc):
    import pandas as pd

    frames, root = prc
    assert frames["p"].keys() == frames["j"].keys()
    for key, by_class in frames["p"].items():
        for cls in ("Cored", "CAA"):
            pd.testing.assert_frame_equal(by_class[cls], frames["j"][key][cls], check_exact=True)
    names = sorted(os.listdir(root / "p" / "PRC"))
    assert names == sorted(os.listdir(root / "j" / "PRC")) and len(names) == 5 * 9 * 2
    for n in names:
        assert (root / "p" / "PRC" / n).read_bytes() == (root / "j" / "PRC" / n).read_bytes()
    # NP1 copies the predictions of its images: all their rows are TPs at 0.9
    np1 = frames["p"][("NP1", 0.9)]
    assert sum(int(f["TP"].sum()) for f in np1.values()) > 0


def test_precision_maps_and_low_performance_images_match_jax(prc):
    _, root = prc
    names = sorted(os.listdir(root / "p" / "maps"))
    assert names == sorted(os.listdir(root / "j" / "maps")) and len(names) == 5 * 9 * 2
    assert "prospective_precision_img_map_Cored_NP1_0.5.pkl" in names
    for n in names:
        with open(root / "p" / "maps" / n, "rb") as a, open(root / "j" / "maps" / n, "rb") as b:
            got, want = pickle.load(a), pickle.load(b)
        assert got == want
        assert P.find_low_performance_images(got) == jax_P.find_low_performance_images(want)


@pytest.mark.parametrize("sklearn", [True, False])
def test_ap_maps_match_jax_in_both_branches(prc, monkeypatch, sklearn):
    _, root = prc
    if not sklearn:  # the numpy branch of average_precision_from_table, on both sides
        monkeypatch.setitem(sys.modules, "sklearn", None)
        monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    annotators = ["consensus", "NP1", "NP2", "NP3", "NP4"]
    got = P.ap_map_from_tables(str(root / "p" / "PRC"), annotators, iou_thresholds=IOUS)
    want = jax_P.ap_map_from_tables(str(root / "j" / "PRC"), annotators, iou_thresholds=IOUS)
    assert got == want
    assert got["NP1"]["Cored"][0.5] > 0


def test_average_precision_branches_agree_on_a_table(monkeypatch):
    import pandas as pd

    rng = np.random.RandomState(9)
    df = pd.DataFrame({"Conf": np.round(rng.rand(30), 3), "TP": rng.randint(0, 2, 30)})
    with_sklearn = P.average_precision_from_table(df)
    assert with_sklearn == jax_P.average_precision_from_table(df)
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    numpy_branch = P.average_precision_from_table(df)
    assert numpy_branch == jax_P.average_precision_from_table(df)
    assert abs(numpy_branch - with_sklearn) < 1e-12


def _nan_equal(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


@pytest.mark.parametrize("t", [0.3, 0.5, 0.9])
def test_interrater_agreement_matches_jax(study, t):
    _, by_np = study
    got = P.get_interrater_agreement(by_np, t)
    want = jax_P.get_interrater_agreement(by_np, t)
    assert got.keys() == want.keys() and len(got) == 6
    for pair in want:
        for cls in P.AMYLOID_CLASSES:
            assert _nan_equal(got[pair][cls], want[pair][cls]), (pair, cls)
    # NP2 is NP1 jittered by <= 2 px: they agree on every box at 0.3
    if t == 0.3:
        assert all(got[("NP1", "NP2")][c] == 1.0 for c in P.AMYLOID_CLASSES)


def test_interrater_agreement_nan_for_an_absent_class():
    by_np = {"NP1": {"img": [({"x1": 0, "y1": 0, "x2": 10, "y2": 10}, "Cored")]},
             "NP2": {"img": []}}
    got = P.get_interrater_agreement(by_np, 0.5)
    want = jax_P.get_interrater_agreement(by_np, 0.5)
    assert got[("NP1", "NP2")]["Cored"] == want[("NP1", "NP2")]["Cored"] == 0.0
    assert math.isnan(got[("NP1", "NP2")]["CAA"]) and math.isnan(want[("NP1", "NP2")]["CAA"])


def test_relative_precisions_and_overlaps_match_jax(study):
    _, by_np = study
    got = P.get_precisions_of_annotators_relative_to_each_other(by_np)
    assert got == jax_P.get_precisions_of_annotators_relative_to_each_other(by_np)
    for ann in by_np.values():
        for t in (0.1, 0.5):
            assert P.get_annotation_overlaps(ann, t) == jax_P.get_annotation_overlaps(ann, t)
    assert P.add_np_label(by_np["NP3"], "NP3") == jax_P.add_np_label(by_np["NP3"], "NP3")


def test_convert_yolo_annotations_matches_jax(tmp_path):
    labels = tmp_path / "labels"
    labels.mkdir()
    rng = np.random.RandomState(4)
    for i in range(3):
        rows = [f"{rng.randint(0, 2)} {x:.6f} {y:.6f} {w:.6f} {h:.6f}"
                for x, y, w, h in rng.uniform(0.05, 0.5, (4, 4))]
        (labels / f"tile_{i}.txt").write_text("\n".join(rows) + "\n\n")
    got = P.convert_yolo_annotations_to_pickle(str(labels), str(tmp_path / "p.pkl"))
    want = jax_P.convert_yolo_annotations_to_pickle(str(labels), str(tmp_path / "j.pkl"))
    assert got == want and sorted(got) == [f"tile_{i}.jpg" for i in range(3)]
    assert (tmp_path / "p.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()


def test_constants_and_all_match_jax():
    assert P.ANNOTATION_TIME_HOURS == jax_P.ANNOTATION_TIME_HOURS
    assert P.AMYLOID_CLASSES == jax_P.AMYLOID_CLASSES
    assert sorted(P.__all__) == sorted(jax_P.__all__)


@pytest.mark.parametrize("libraries", ["all", "no_matplotlib_no_sklearn"])
def test_study_script_runs_on_the_cpu(tmp_path, monkeypatch, capsys, libraries):
    """``examples/run_study_torch.py --synthetic --device cpu``, with the
    mini graph at 416 in place of YOLOv3: its five stages and its
    artifacts; without matplotlib and sklearn (as on a machine that has
    only pandas) the AP maps and no figures."""
    if libraries != "all":
        for m in ("matplotlib", "sklearn", "sklearn.metrics"):
            monkeypatch.setitem(sys.modules, m, None)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples"))
    try:
        import run_study_torch
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(run_study_torch, "yolov3_spec",
                        lambda num_classes: port_mini_spec(num_classes, img_size=416))
    work = tmp_path / "study"
    assert run_study_torch.main(["--synthetic", "--workdir", str(work), "--device", "cpu",
                                 "--caa_filter"]) == 0
    out = capsys.readouterr().out
    for stage in range(1, 6):
        assert f"[{stage}/5]" in out
    assert len(os.listdir(work / "PRC_tables")) == 3 * 9 * 2
    with open(work / "pickles" / "APs_per_annotator.pkl", "rb") as fh:
        ap_map = pickle.load(fh)
    assert sorted(ap_map) == ["NP1", "NP2", "consensus"]
    assert ap_map == P.ap_map_from_tables(str(work / "PRC_tables"), sorted(ap_map))
    if libraries == "all":
        assert "interrater_agreement_accuracy_Cored_0.5.png" in os.listdir(work / "figures")
    else:
        assert not (work / "figures").exists() and "no figures" in out
