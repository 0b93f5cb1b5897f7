"""The port's CERAD statistics, speed check and sliding-window comparison
(``analysis/validation.py``) against the JAX package's.

Tolerances: the CERAD category lists and the statistical power are
exactly equal, the t-test map within 1e-12 (scipy on the same lists), the
figures' file names equal (not their PNG bytes).  ``speed_check`` times
the host, so only its shape is held: the same keys, the tiles counted, and
the WSIs that divide the model time.
"""

import os
import pickle
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amyloid_yolo_tpu.analysis import validation as jax_v
from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.domain import CAAFilter as JaxCAAFilter
from amyloid_yolo_tpu_torch.analysis import validation as v
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.domain import CAAFilter
from amyloid_yolo_tpu_torch.io import tiles
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import classifier

from minispec import mini_spec
from torch_port_helpers import (jax_classifier_params, jax_params_np, low_dpi_figures,
                                port_mini_spec, stain_tile)

T_TEST_ATOL = 1e-12
CATEGORIES = ["none", "sparse", "moderate", "frequent"]


@pytest.fixture(autouse=True)
def _low_dpi(monkeypatch):
    low_dpi_figures(monkeypatch)


@pytest.fixture(scope="module")
def cerad(tmp_path_factory):
    """The cases of ``tests/test_integration_wsi.py::test_cerad_plots``
    (8 WSIs), and 16 with random counts, one WSI missing from the pickle."""
    import pandas as pd

    root = tmp_path_factory.mktemp("cerad")
    rng = np.random.RandomState(3)
    out = {}
    for name, n in (("reference", 8), ("random", 16)):
        if name == "reference":
            counts = {f"W{i}": {"Cored": int(i * 3), "CAA": int(i)} for i in range(n)}
        else:
            counts = {f"W{i}": {"Cored": int(rng.randint(0, 200)), "CAA": int(rng.randint(0, 40))}
                      for i in range(1, n)}
        rows = [{"WSI_ID": f"W{i}", "CERAD": CATEGORIES[i % 4], "Cored_MTG": i % 4,
                 "CAA_MTG": (i // 2) % 4} for i in range(n)]
        cp, csv = root / f"{name}_counts.pkl", root / f"{name}_CERAD.csv"
        with open(cp, "wb") as fh:
            pickle.dump(counts, fh)
        pd.DataFrame(rows).to_csv(csv, index=False)
        out[name] = (str(cp), str(csv))
    return out, root


@pytest.mark.parametrize("case,plaque,cerad_type", [("reference", "Cored", "CERAD"),
                                                    ("random", "CAA", "CERAD"),
                                                    ("random", "Cored", "Cored_MTG")])
def test_plot_cerad_vs_counts_matches_jax(cerad, case, plaque, cerad_type):
    files, root = cerad
    figs = {side: root / f"{case}_{plaque}_{cerad_type}_{side}" for side in "pj"}
    got = v.plot_cerad_vs_counts(*files[case], plaque, cerad_type, figures_dir=str(figs["p"]))
    want = jax_v.plot_cerad_vs_counts(*files[case], plaque, cerad_type,
                                      figures_dir=str(figs["j"]))
    assert got == want
    assert sum(len(c) for c in got.values()) == (8 if case == "reference" else 15)
    assert os.listdir(figs["p"]) == os.listdir(figs["j"]) == [
        f"CERAD_correlation_{plaque}_{cerad_type}.png"]


@pytest.mark.parametrize("case,plaque", [("reference", "Cored"), ("random", "CAA")])
def test_plot_cerad_statistical_significance_matches_jax(cerad, case, plaque):
    files, root = cerad
    figs = {side: root / f"sig_{case}_{plaque}_{side}" for side in "pj"}
    got = v.plot_cerad_statistical_significance(*files[case], plaque,
                                                figures_dir=str(figs["p"]))
    want = jax_v.plot_cerad_statistical_significance(*files[case], plaque,
                                                     figures_dir=str(figs["j"]))
    assert list(got) == list(want) and len(got) == 16 and ("none", "frequent") in got
    for key, w in want.items():
        t, p, power = got[key]
        np.testing.assert_allclose([t, p], w[:2], rtol=0, atol=T_TEST_ATOL, equal_nan=True)
        assert power == w[2] or (np.isnan(power) and np.isnan(w[2]))
    assert os.listdir(figs["p"]) == os.listdir(figs["j"]) == ["CERAD-t-test-p-values.png"]


@pytest.mark.parametrize("effect,nobs,alpha", [(0.0, 10, 0.05), (0.5, 20, 0.05),
                                               (1.3, 8, 0.01), (-0.8, 40, 0.1),
                                               (2.5, 4, 0.05)])
def test_ttest_power_matches_jax(effect, nobs, alpha):
    got = v._ttest_power(effect, nobs, alpha)
    assert got == jax_v._ttest_power(effect, nobs, alpha)
    assert 0.0 <= got <= 1.0


def test_tang_sliding_window_matches_jax():
    assert v.TANG_TQDM_LOGS == jax_v.TANG_TQDM_LOGS
    avg = v.calculate_avg_speed_of_tang_sliding_window()
    assert avg == jax_v.calculate_avg_speed_of_tang_sliding_window()
    assert 370 < avg < 385


def test_all_matches_jax():
    assert sorted(v.__all__) == sorted(jax_v.__all__)


# -- speed_check ------------------------------------------------------------------

CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)


@pytest.fixture(scope="module")
def speed_setup(tmp_path_factory):
    """Two 640² WSIs tiled into 256² tiles (9 each, the edge tiles partial),
    and both packages' float32 mini Detectors and CAA filters."""
    root = tmp_path_factory.mktemp("speed")
    rng = np.random.RandomState(8)
    for name in ("WSI_A", "WSI_B"):
        tiles.tile_image_array(stain_tile(rng, 640, 640), str(root / "tree"), name,
                               tile_size=256)
    params = jax_params_np(mini_spec(), 4, jit=True)
    cparams = jax_classifier_params(3, fc_scale=8.0, jit=True)
    spec = port_mini_spec()
    det = Detector(spec, params_from_jax(params, spec), device="cpu",
                   compute_dtype=torch.float32, **CFG)
    jdet = JaxDetector(mini_spec(), params, compute_dtype=jnp.float32, **CFG)
    caa = CAAFilter(classifier.from_jax_params(cparams), device="cpu")
    return root, (det, caa), (jdet, JaxCAAFilter(cparams))


@pytest.mark.parametrize("merge_and_filter", [True, False])
def test_speed_check_matches_jax(speed_setup, merge_and_filter):
    root, port, ref = speed_setup
    tree = str(root / "tree")
    out = {}
    for side, (det, caa), fn in (("p", port, v.speed_check), ("j", ref, jax_v.speed_check)):
        out[side] = fn(tree, det, caa_filter=caa, include_merge_and_filter=merge_and_filter,
                       batch_sizes=(4,), pickles_dir=str(root / side))
    host = socket.gethostname()
    suffix = f"_merge_and_filter_{merge_and_filter}_{host}.pkl"
    # the default tag names each package's platform
    assert os.path.exists(root / "p" / f"run_times_cpu{suffix}")
    assert os.path.exists(root / "j" / f"run_times_tpu{suffix}")
    with open(root / "p" / f"run_times_cpu{suffix}", "rb") as fh:
        assert pickle.load(fh).keys() == out["p"].keys()
    assert out["p"].keys() == out["j"].keys() == {4}
    got, want = out["p"][4], out["j"][4]
    assert list(got) == list(want)
    assert got["num 1536 images"] == want["num 1536 images"] == 18
    assert got["machine"] == want["machine"] == host
    for rec in (got, want):
        assert rec["down time"] >= 0 and rec["model time spent"] > 0
        assert rec["model time spent"] / rec["avg time / WSI"] == pytest.approx(2.0)
        assert rec["model time spent"] / rec["avg time / 1536 img"] == pytest.approx(18.0)


def test_speed_check_tag_and_cpu_device(speed_setup, tmp_path):
    _, (det, _), _ = speed_setup
    tree = str(speed_setup[0] / "tree")
    got = v.speed_check(tree, det, batch_sizes=(1, 2), pickles_dir=str(tmp_path), tag="h100")
    assert got[1]["num 1536 images"] == got[2]["num 1536 images"] == 18
    assert [n for n in os.listdir(tmp_path) if n.startswith("run_times_h100_")]
