"""The port's study figures (``analysis/plots.py``) and data checks
(``analysis/data_checks.py``) against the JAX package's.

Each plot function returns the same dict or summary and writes the same
set of file names (matplotlib's PNG bytes are not compared); the two that
draw with PIL write pixel-equal images.  Each data check passes and raises
on the same inputs in both packages.
"""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from amyloid_yolo_tpu.analysis import data_checks as jax_dc
from amyloid_yolo_tpu.analysis import plots as jax_plots
from amyloid_yolo_tpu.analysis import prospective as jax_P
from amyloid_yolo_tpu_torch.analysis import data_checks as dc
from amyloid_yolo_tpu_torch.analysis import plots

from torch_port_helpers import low_dpi_figures, stain_tile

NPS = ["NP1", "NP2", "NP3", "NP4"]
IOUS = list(np.arange(0.1, 1.0, 0.1))


@pytest.fixture(autouse=True)
def _low_dpi(monkeypatch):
    low_dpi_figures(monkeypatch)


def _box(rng, side=256):
    x, y = (int(v) for v in rng.randint(0, side - 60, 2))
    w, h = (int(v) for v in rng.randint(12, 60, 2))
    return {"x1": x, "y1": y, "x2": x + w, "y2": y + h}


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Four annotator sets and predictions over 4 small tiles, the PRC
    tables of the consensus, the annotators and two model phases (written
    by the JAX package), and the tiles."""
    root = tmp_path_factory.mktemp("plots")
    rng = np.random.RandomState(21)
    images = root / "images"
    images.mkdir()
    truth, preds = {}, {}
    for i in range(4):
        name = f"img_{i}.jpg"
        Image.fromarray(stain_tile(rng, 256, 256)).save(images / name, quality=90)
        truth[name] = [(_box(rng), "Cored" if rng.rand() < 0.5 else "CAA") for _ in range(5)]
        preds[name] = []
        for d, c in truth[name] + [(_box(rng), "CAA"), (_box(rng), "Cored")]:
            conf = float(np.round(rng.uniform(0.3, 1.0), 4))
            preds[name].append(({**{k: v + int(rng.randint(-3, 4)) for k, v in d.items()},
                                 "conf": conf, "cls_conf": conf,
                                 "cls_pred": 1.0 if c == "Cored" else 0.0}, c))
    by_np = {}
    for k, a in enumerate(NPS):
        by_np[a] = {n: [({kk: v + int(rng.randint(-k, k + 1)) for kk, v in d.items()}, c)
                        for d, c in e if rng.rand() > 0.15 * k] for n, e in truth.items()}
    prc = str(root / "PRC")
    for t in IOUS:
        consensus = jax_P.create_merged_or_consensus_benchmark(by_np, "consensus", t)
        for annotator, ann in [("consensus", consensus)] + list(by_np.items()):
            jax_P.compare_annotations_to_predictions(ann, preds, t, annotator, "prospective",
                                                     prc_dir=prc, precision_maps_dir=None)
        for phase in ("phase1", "phase2"):
            jax_P.compare_annotations_to_predictions(consensus, preds, t, phase, phase,
                                                     prc_dir=prc, precision_maps_dir=None)
    return root, by_np, preds


def _both(root, name, fn, jax_fn, *args, **kw):
    """Run the port's and the JAX package's function into two figure
    folders; returns (port result, JAX result, port files, JAX files)."""
    dirs = [root / f"{name}_p", root / f"{name}_j"]
    got = fn(*args, figures_dir=str(dirs[0]), **kw)
    want = jax_fn(*args, figures_dir=str(dirs[1]), **kw)
    return got, want, sorted(os.listdir(dirs[0])), sorted(os.listdir(dirs[1]))


@pytest.mark.parametrize("separate_legend", [True, False])
def test_plot_prc_writes_the_same_files(study, separate_legend):
    root, _, _ = study
    _, _, got, want = _both(root, f"prc_{separate_legend}", plots.plot_prc, jax_plots.plot_prc,
                            str(root / "PRC"), "NP2", separate_legend=separate_legend)
    assert got == want
    assert len(got) == (4 if separate_legend else 2)


def test_plot_aps_for_prospective_matches_jax(study):
    root, by_np, _ = study
    summary = jax_plots.plot_precisions_relative_to_each_other(
        jax_P.get_precisions_of_annotators_relative_to_each_other(by_np),
        figures_dir=str(root / "summary_j"))
    got, want, gf, wf = _both(root, "aps", plots.plot_aps_for_prospective,
                              jax_plots.plot_aps_for_prospective, str(root / "PRC"),
                              annotators=["consensus"] + NPS, overlay_summary=summary,
                              ap_map_pickle=str(root / "aps.pkl"))
    assert got == want and gf == wf
    assert gf == ["PRC_cumulative_plot_CAA.png", "PRC_cumulative_plot_Cored.png"]
    with open(root / "aps.pkl", "rb") as fh:  # the JAX run wrote it last
        assert pickle.load(fh) == got
    assert 0 < got["NP1"]["Cored"][0.5] <= 1


def test_plot_aps_for_phases_matches_jax(study):
    root, _, _ = study
    got, want, gf, wf = _both(root, "phases", plots.plot_aps_for_phases,
                              jax_plots.plot_aps_for_phases, str(root / "PRC"))
    assert got == want and list(got) == ["phase1", "phase2"]
    assert gf == wf == ["PRC_cumulative_plot_phase1.png", "PRC_cumulative_plot_phase2.png"]


def test_plot_interrater_agreement_and_time_chart_write_the_same_files(study):
    root, by_np, _ = study
    pair_map = jax_P.get_interrater_agreement(by_np, 0.5)
    _, _, gf, wf = _both(root, "inter", plots.plot_interrater_agreement,
                         jax_plots.plot_interrater_agreement, pair_map, iou_threshold=0.5)
    assert gf == wf == [f"interrater_agreement_accuracy_{c}_0.5.png" for c in ("CAA", "Cored")]
    ap_map = jax_P.ap_map_from_tables(str(root / "PRC"), NPS, iou_thresholds=[0.5])
    _, _, gf, wf = _both(root, "time", plots.plot_time_chart, jax_plots.plot_time_chart, ap_map)
    assert gf == wf == ["time_vs_AP.png"]


@pytest.mark.parametrize("plot_type", ["aggregate", "individual"])
def test_plot_precisions_relative_to_each_other_matches_jax(study, plot_type):
    root, by_np, _ = study
    precisions = jax_P.get_precisions_of_annotators_relative_to_each_other(
        by_np, iou_thresholds=[0.1, 0.5, 0.9])
    got, want, gf, wf = _both(root, f"rel_{plot_type}",
                              plots.plot_precisions_relative_to_each_other,
                              jax_plots.plot_precisions_relative_to_each_other, precisions,
                              plot_type=plot_type)
    assert gf == wf and len(gf) == 2 * 5
    assert list(got) == list(want) == ["Cored", "CAA"]
    for cls in got:
        assert got[cls]["x"] == want[cls]["x"]
        np.testing.assert_array_equal(got[cls]["avg"], want[cls]["avg"])
        np.testing.assert_array_equal(got[cls]["std"], want[cls]["std"])


def _pixels_equal(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(a, n))),
                                      np.asarray(Image.open(os.path.join(b, n))))
    return names


def test_plot_all_annotations_and_image_comparisons_pixel_equal(study):
    root, by_np, preds = study
    images = str(root / "images")
    plots.plot_all_annotations(by_np, images, output_dir=str(root / "all_p"))
    jax_plots.plot_all_annotations(by_np, images, output_dir=str(root / "all_j"))
    assert len(_pixels_equal(root / "all_p", root / "all_j")) == 4
    for labels, predictions in ((True, True), (False, True), (True, False)):
        kw = dict(overlay_labels=labels, overlay_predictions=predictions)
        out = [root / f"cmp_{labels}_{predictions}_{s}" for s in "pj"]
        plots.plot_image_comparisons(by_np["NP1"], preds, images, str(out[0]), **kw)
        jax_plots.plot_image_comparisons(by_np["NP1"], preds, images, str(out[1]), **kw)
        assert _pixels_equal(*out)[0] == "prospective_img_0.jpg"


def test_plots_constants_match_jax():
    assert plots.ANNOTATOR_COLORS == jax_plots.ANNOTATOR_COLORS
    assert sorted(plots.__all__) == sorted(jax_plots.__all__)
    assert sorted(dc.__all__) == sorted(jax_dc.__all__)


# -- data checks: tests/test_data_checks.py through both packages --------------

@pytest.mark.parametrize("mod", [dc, jax_dc], ids=["port", "jax"])
def test_train_valid_disjoint(tmp_path, mod):
    (tmp_path / "train.txt").write_text("a.jpg\nb.jpg\n")
    (tmp_path / "valid.txt").write_text("c.jpg\n")
    mod.check_train_valid_disjoint(str(tmp_path / "train.txt"), str(tmp_path / "valid.txt"))
    (tmp_path / "valid2.txt").write_text("b.jpg\n")
    with pytest.raises(AssertionError, match="overlap"):
        mod.check_train_valid_disjoint(str(tmp_path / "train.txt"), str(tmp_path / "valid2.txt"))


@pytest.mark.parametrize("mod", [dc, jax_dc], ids=["port", "jax"])
def test_split_identity(tmp_path, mod):
    for d in ("p1", "p2"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "train.txt").write_text("a.jpg\nb.jpg\n")
        (tmp_path / d / "valid.txt").write_text("c.jpg\n")
    mod.check_split_identity_across_phases(str(tmp_path / "p1"), str(tmp_path / "p2"))
    (tmp_path / "p2" / "train.txt").write_text("a.jpg\n")
    with pytest.raises(AssertionError, match="train.txt differs"):
        mod.check_split_identity_across_phases(str(tmp_path / "p1"), str(tmp_path / "p2"))


@pytest.mark.parametrize("mod", [dc, jax_dc], ids=["port", "jax"])
def test_consensus_subset(mod):
    ann = ({"x1": 0, "y1": 0, "x2": 10, "y2": 10}, "Cored")
    mod.check_consensus_subset_of_annotators({"img": [ann]}, {"NP1": {"img": [ann]}})
    stranger = ({"x1": 5, "y1": 5, "x2": 15, "y2": 15}, "Cored")
    with pytest.raises(AssertionError):
        mod.check_consensus_subset_of_annotators({"img": [stranger]}, {"NP1": {"img": [ann]}})


@pytest.mark.parametrize("mod", [dc, jax_dc], ids=["port", "jax"])
def test_precision_map_empties(mod):
    preds = {"img": [(None, "Cored")]}
    mod.check_precision_map_empties({"img": -1, "other": 0.5}, preds, "CAA")
    with pytest.raises(AssertionError):
        mod.check_precision_map_empties({"img": -1}, preds, "Cored")


@pytest.mark.parametrize("mod", [dc, jax_dc], ids=["port", "jax"])
def test_preprocess_golden(tmp_path, mod):
    mapp = {"x": [(1, 2)]}
    p = tmp_path / "g.pkl"
    with open(p, "wb") as fh:
        pickle.dump(mapp, fh)
    mod.check_preprocess_against_golden(mapp, str(p))
    with pytest.raises(AssertionError):
        mod.check_preprocess_against_golden({"x": []}, str(p))


def _composition_rows(n_wsis=56):
    """200 images: 96 CAA- and 96 Cored-enriched, 144 chosen by the model
    and 48 by a human, 50 per stain, over ``n_wsis`` WSIs."""
    stains = ["4G8", "6E10", "ABeta40", "ABeta42"]
    rows = []
    for i in range(200):
        rows.append({"Image Name": f"/x/data/MRPI_tiles/WSI{i % n_wsis}/0/{i}.jpg",
                     "Amyloid Class": "CAA" if i < 96 else ("Cored" if i < 192 else "none"),
                     "Selected by": "Model" if i < 144 else ("Human" if i < 192 else "?"),
                     "Stain": stains[i % 4]})
    return rows


@pytest.mark.parametrize("n_wsis,ok", [(56, True), (55, False)])
def test_prospective_composition(tmp_path, n_wsis, ok):
    import pandas as pd

    csv = tmp_path / "composition.csv"
    pd.DataFrame(_composition_rows(n_wsis)).to_csv(csv, index=False)
    for mod in (dc, jax_dc):
        if ok:
            mod.check_prospective_composition(str(csv))
        else:
            with pytest.raises(AssertionError, match="expected 56 WSIs"):
                mod.check_prospective_composition(str(csv))


def _precision_dict(cored_05, caa_05, cored_01, caa_01):
    return {cls: {a1: {a2: {0.5: v05, 0.1: v01} for a2 in NPS if a2 != a1} for a1 in NPS}
            for cls, v05, v01 in (("Cored", cored_05, cored_01), ("CAA", caa_05, caa_01))}


@pytest.mark.parametrize("values,ok", [((0.65, 0.55, 0.65, 0.62), True),
                                       ((0.65, 0.55, 0.65, 0.7), False),
                                       ((0.5, 0.55, 0.65, 0.62), False)])
def test_interrater_precision_bounds(values, ok):
    d = _precision_dict(*values)
    for mod in (dc, jax_dc):
        if ok:
            mod.check_interrater_precision_bounds(d)
        else:
            with pytest.raises(AssertionError):
                mod.check_interrater_precision_bounds(d)
