"""The port's WSI tiling (``io/tiles.py``) and whole-slide sweep
(``analysis/validation.py``) against the JAX package's, on trees PIL writes
into ``tmp_path``.

Tiling is host code: file lists, names and bytes must be equal.  The sweep
runs the mini spec in float32 on both sides (tile 256, conf 0.3) with the
same CAA classifier: the two count pickles must be equal, with the
cross-tile merge off and on, and with the background prefilter.
"""

import os
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu.analysis import validation as jax_validation
from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.domain import CAAFilter as JaxCAAFilter
from amyloid_yolo_tpu.io import tiles as jax_tiles
from amyloid_yolo_tpu_torch.analysis import validation
from amyloid_yolo_tpu_torch.detectors import Detector
from amyloid_yolo_tpu_torch.domain import CAAFilter
from amyloid_yolo_tpu_torch.io import tiles
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import classifier

from minispec import mini_spec
from torch_port_helpers import jax_classifier_params, jax_params_np, port_mini_spec, stain_tile

CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _slide(seed, h, w, blank_corner=False):
    img = stain_tile(np.random.RandomState(seed), h, w)
    if blank_corner:  # a background tile for the prefilters
        img[:256, :256] = 243
    return img


@pytest.mark.parametrize("min_tissue", [0.0, 0.05])
def test_tile_image_array_matches_jax(tmp_path, min_tissue):
    img = _slide(0, 600, 700, blank_corner=True)
    skipped, jskipped = [], []
    got = tiles.tile_image_array(img, str(tmp_path / "p"), "W", tile_size=256,
                                 min_tissue_fraction=min_tissue, skipped_out=skipped)
    want = jax_tiles.tile_image_array(img, str(tmp_path / "j"), "W", tile_size=256,
                                      min_tissue_fraction=min_tissue, skipped_out=jskipped)
    assert [os.path.relpath(p, tmp_path / "p") for p in got] == \
        [os.path.relpath(p, tmp_path / "j") for p in want]
    assert skipped == jskipped and (min_tissue == 0) == (skipped == [])
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert tiles.iter_wsi_tile_dirs(str(tmp_path / "p")) == [
        (w, d.replace(str(tmp_path / "j"), str(tmp_path / "p")))
        for w, d in jax_tiles.iter_wsi_tile_dirs(str(tmp_path / "j"))]


def test_tile_origin_matches_jax():
    paths = ["/r/W/0/3/5.jpg", "/r/W/0/0/0.jpg", "W/0/12/7.png", "/r/W/0/x/5.jpg",
             "/r/W/1/3/5.jpg", "/r/W/0/W_1_3/5.jpg", "5.jpg", "/r/W/0/7.jpg", "a/b"]
    for p in paths:
        for ts in (1536, 256):
            assert tiles.tile_origin(p, ts) == jax_tiles.tile_origin(p, ts), p
    assert tiles.tile_origin("/r/W/0/3/5.jpg") == (5 * 1536, 3 * 1536)


def test_iter_wsi_tile_dirs_flat_and_google_layouts(tmp_path):
    for w, layout in (("A", "google"), ("B", "flat"), ("C", "empty"), ("D", "none")):
        zero = tmp_path / w / "0"
        if layout == "google":
            for r in ("0", "1"):
                (zero / r).mkdir(parents=True)
                (zero / r / "0.jpg").write_bytes(b"x")
        elif layout == "flat":
            zero.mkdir(parents=True)
            (zero / "a.jpg").write_bytes(b"x")
        elif layout == "empty":
            zero.mkdir(parents=True)
        else:
            (tmp_path / w).mkdir()
    got = tiles.iter_wsi_tile_dirs(str(tmp_path))
    assert got == jax_tiles.iter_wsi_tile_dirs(str(tmp_path))
    assert [w for w, _ in got] == ["A", "A", "B"]


def _divide_and_conquer_tree(root):
    for prefix in ["1_W", "2_W", "3_W", "W", "1_V", "V"]:
        for sub in ("0", "1"):
            os.makedirs(root / prefix / "0" / sub, exist_ok=True)
            (root / prefix / "0" / sub / f"{prefix}.jpg").write_bytes(prefix.encode())


def test_merge_rename_and_clear_match_jax(tmp_path):
    for side, mod in (("p", tiles), ("j", jax_tiles)):
        root = tmp_path / side
        _divide_and_conquer_tree(root)
        mod.merge_1536_subdirectories(str(root))
        (root / "slide_temp.svs").mkdir()  # the name the map records
        with open(tmp_path / f"{side}.pkl", "wb") as fh:
            pickle.dump({"/in/slide_temp.svs": "real_slide", "/in/other.svs": "o"}, fh)
        mod.rename_temp_directories(str(root), str(tmp_path / f"{side}.pkl"))
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert sorted(os.listdir(tmp_path / "p")) == ["V", "W", "real_slide"]
    assert sorted(os.listdir(tmp_path / "p" / "W" / "0")) == [
        f"W_{i}_{s}" for i in (1, 2, 3) for s in ("0", "1")]
    holdout = tmp_path / "holdout"
    holdout.mkdir()
    (holdout / "W.svs").write_bytes(b"")
    for side, mod in (("p", tiles), ("j", jax_tiles)):
        mod.clear_1536_directory(str(tmp_path / side), str(holdout))
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j")) == ["W"]


def test_crop_wsis_and_save_and_tile_match_jax(tmp_path):
    """Without pyvips (absent here, as on the GPU machine) both take the PIL
    tiler; a file PIL cannot read fails both tilers and is reported."""
    assert tiles.have_pyvips() == jax_tiles.have_pyvips()
    wsis = tmp_path / "wsis"
    wsis.mkdir()
    Image.fromarray(_slide(1, 300, 520)).save(wsis / "slide_a.png")
    Image.fromarray(_slide(2, 256, 256)).save(wsis / "slide_b.tif")
    (wsis / "broken.svs").write_bytes(b"not a slide")
    got = tiles.crop_wsis([str(wsis)], str(tmp_path / "p"), str(tmp_path / "p.pkl"))
    want = jax_tiles.crop_wsis([str(wsis)], str(tmp_path / "j"), str(tmp_path / "j.pkl"))
    assert got == want == ["broken.svs"]
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    assert sorted(os.listdir(tmp_path / "p")) == ["slide_a", "slide_b"]
    with open(tmp_path / "p.pkl", "rb") as a, open(tmp_path / "j.pkl", "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    with pytest.raises(RuntimeError, match="pyvips"):
        tiles.divide_and_conquer(str(wsis / "slide_a.png"), str(tmp_path / "d"))
    tiles.save_and_tile(str(wsis / "slide_a.png"), str(tmp_path / "s"), tile_size=256,
                        min_tissue_fraction=0.5)
    jax_tiles.save_and_tile(str(wsis / "slide_a.png"), str(tmp_path / "t"), tile_size=256,
                            min_tissue_fraction=0.5)
    assert _tree(tmp_path / "s") == _tree(tmp_path / "t")


@pytest.mark.parametrize("name", ["x_4G8_y", "CERAD_Abeta42_3", "Abeta40", "beta_amyloid_s",
                                  "4G8_Abeta42", "unknown"])
def test_get_stain_matches_jax(name):
    try:
        want = jax_validation.get_stain(name)
    except Exception as e:  # noqa: BLE001 - the reference raises a bare Exception
        with pytest.raises(Exception, match=str(e)):
            validation.get_stain(name)
    else:
        assert validation.get_stain(name) == want


# -- the sweep ----------------------------------------------------------------

@pytest.fixture(scope="module")
def wsi_tree(tmp_path_factory):
    """Two WSIs in the google layout at tile 256: a 600x700 slide (3x3 tiles,
    partial edges, one background tile) and a 512x512 one (2x2)."""
    root = tmp_path_factory.mktemp("wsis")
    tiles.tile_image_array(_slide(3, 600, 700, blank_corner=True), str(root), "CERAD_A",
                           tile_size=256)
    tiles.tile_image_array(_slide(4, 512, 512), str(root), "CERAD_B", tile_size=256)
    return str(root)


@pytest.fixture(scope="module")
def sweepers():
    params = jax_params_np(mini_spec(), 4, jit=True)
    cparams = jax_classifier_params(3, fc_scale=8.0)
    spec = port_mini_spec()

    def port():
        return (Detector(spec, params_from_jax(params, spec), device="cpu",
                         compute_dtype=torch.float32, **CFG),
                CAAFilter(classifier.from_jax_params(cparams), device="cpu"))

    def jax():
        return (JaxDetector(mini_spec(), params, compute_dtype=jnp.float32, **CFG),
                JaxCAAFilter(cparams))

    return port, jax


def _sweep(fn, make, tree, out, **kw):
    det, caa = make()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        counts = fn(tree, det, caa_filter=caa, prefix="X_", pickles_dir=str(out),
                    batch_size=4, **kw)
    pickles = {}
    for name in ("X_WSI_plaque_counts_dictionary.pkl", "X_1536_plaque_counts_dictionary.pkl"):
        with open(out / name, "rb") as fh:
            pickles[name] = pickle.load(fh)
    overflow = [str(x.message) for x in w if "NMS candidate pool" in str(x.message)]
    return counts, pickles, overflow


@pytest.mark.parametrize("kw", [{}, {"cross_tile_merge": True}, {"background_skip": True},
                                {"cross_tile_merge": True, "background_skip": True,
                                 "save_images": True}],
                         ids=["per-tile", "cross-tile", "background_skip", "all"])
def test_sweep_pickles_match_jax(wsi_tree, sweepers, tmp_path, kw, capsys):
    port, jax = sweepers
    if kw.get("save_images"):
        kw = dict(kw)
        got_kw = dict(kw, output_dir=str(tmp_path / "img_p"))
        want_kw = dict(kw, output_dir=str(tmp_path / "img_j"))
    else:
        got_kw = want_kw = kw
    got = _sweep(validation.calculate_plaque_counts_per_wsi, port, wsi_tree,
                 tmp_path / "p", **got_kw)
    port_log = capsys.readouterr().out
    want = _sweep(jax_validation.calculate_plaque_counts_per_wsi, jax, wsi_tree,
                  tmp_path / "j", **want_kw)
    assert capsys.readouterr().out == port_log
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2] == want[2]  # the overflow warning, word for word
    wsi = got[1]["X_WSI_plaque_counts_dictionary.pkl"]
    per_tile = got[1]["X_1536_plaque_counts_dictionary.pkl"]
    assert sorted(wsi) == ["CERAD_A", "CERAD_B"] and sum(c["Cored"] + c["CAA"]
                                                         for c in wsi.values()) > 0
    assert len(per_tile["CERAD_A"]) == 9 and len(per_tile["CERAD_B"]) == 4
    if kw.get("background_skip"):
        assert "background prefilter skipped 1/9" in port_log
    if kw.get("save_images"):
        assert sorted(os.listdir(tmp_path / "img_p")) == sorted(os.listdir(tmp_path / "img_j"))
        assert os.listdir(tmp_path / "img_p")


def test_cross_tile_merge_counts_a_straddler_once(tmp_path):
    """``tests/test_cross_tile.py``'s stub detector through the port's sweep:
    one plaque cut by a tile boundary counts once with the cross-tile merge
    and twice without."""
    ts = 64
    img = np.zeros((ts, 2 * ts, 3), np.uint8)
    img[:, :ts, 0] = 10
    img[:, ts:, 0] = 200
    tiles.tile_image_array(img, str(tmp_path / "root"), "WSI_X", tile_size=ts)

    def row(x1, y1, x2, y2):
        return np.array([[x1, y1, x2, y2, 0.9, 0.9, 1]], np.float32)

    class Stub:
        """Dense (B, 1, 7) rows, one box a tile, through the port's own
        ``Detector.detect_dataset``."""
        tile_size, host_resize, precision, _last_ncand = ts, False, "bf16", None
        detect_dataset = Detector.detect_dataset

        def __call__(self, batch):
            dets = np.stack([row(50, 20, 63, 40) if im[..., 0].mean() < 100
                             else row(0, 22, 12, 38) for im in batch])
            return torch.from_numpy(dets), torch.ones(dets.shape[:2], dtype=torch.bool)

        def account_overflow(self, n_valid=None, n_cand=None):
            return 0

    for cross, want in ((True, 1), (False, 2)):
        counts = validation.calculate_plaque_counts_per_wsi(
            str(tmp_path / "root"), Stub(), pickles_dir=str(tmp_path / f"p{cross}"),
            batch_size=2, cross_tile_merge=cross)
        assert counts["WSI_X"] == {"Cored": want, "CAA": 0}
