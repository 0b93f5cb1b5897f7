"""The port's folder path against the JAX package's: ``ops/preprocess``'s
padding and crops, ``ops/boxes.rescale_from_tile_frame``, ``io/datasets``'s
``ImageFolder``, ``resolve_batch_size``, ``Detector._calibrate_from_folder``
and ``Detector.detect_folder``, on tiles PIL writes into ``tmp_path``.

Tolerances: host numpy (padding, batches, orig_shapes, n_valid, rescale,
crops) is exact.  ``detect_folder`` runs the mini graph in float32 on both
sides: the same keys, the same ``None``s and the same row counts; boxes
before the merge within ``BOX_ATOL`` px and scores within ``SCORE_ATOL``
(the JAX pipeline is compiled, so XLA reorders float epilogues).  Folder
calibration: the same scales within rtol 1e-6 and the same provenance.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from amyloid_yolo_tpu.detectors import Detector as JaxDetector
from amyloid_yolo_tpu.detectors import resolve_batch_size as jax_resolve_batch_size
from amyloid_yolo_tpu.domain import CAAFilter as JaxCAAFilter
from amyloid_yolo_tpu.io import datasets as jax_datasets
from amyloid_yolo_tpu.ops import boxes as jax_boxes
from amyloid_yolo_tpu.ops import preprocess as jax_pre
from amyloid_yolo_tpu_torch.detectors import Detector, resolve_batch_size
from amyloid_yolo_tpu_torch.domain import CAAFilter
from amyloid_yolo_tpu_torch.io import datasets, native
from amyloid_yolo_tpu_torch.io.weights import params_from_jax
from amyloid_yolo_tpu_torch.models import classifier
from amyloid_yolo_tpu_torch.ops import boxes, preprocess

from minispec import mini_spec
from torch_port_helpers import (jax_classifier_params, jax_params_np, port_mini_spec,
                                write_tile_folder)

BOX_ATOL = 1e-3
SCORE_ATOL = 1e-4
CFG = dict(conf_thres=0.3, nms_thres=0.4, model_size=64, tile_size=256, capacity=16)


# -- ops/preprocess and ops/boxes ---------------------------------------------

@pytest.mark.parametrize("hw", [(10, 20), (20, 10), (7, 7), (1000, 1536), (1536, 999)])
def test_pad_amounts_and_pad_to_square_match_jax(hw):
    assert preprocess.pad_amounts(*hw) == jax_pre.pad_amounts(*hw)
    img = np.random.RandomState(0).randint(0, 255, hw + (3,)).astype(np.uint8)
    got, pads = datasets.pad_to_square_np(img)
    want, want_pads = jax_datasets.pad_to_square_np(img)
    assert pads == want_pads and got.shape[0] == got.shape[1] == max(hw)
    np.testing.assert_array_equal(got, want)


def test_crop256_window_and_crop_match_jax(rng):
    img = rng.randint(0, 255, (1536, 1536, 3)).astype(np.uint8)
    for _ in range(300):
        bbox = (int(rng.randint(-50, 1600)), int(rng.randint(-50, 1600)),
                int(rng.randint(0, 400)), int(rng.randint(0, 400)))
        assert preprocess.crop256_window(bbox) == jax_pre.crop256_window(bbox)
        np.testing.assert_array_equal(preprocess.crop256(img, bbox), jax_pre.crop256(img, bbox))


def test_batched_crop256_matches_jax(rng):
    tile = rng.randint(0, 255, (600, 700, 3)).astype(np.uint8)
    origins = np.array([[0, 0], [444, 344], [100, 37], [500, 400], [-3, 9], [20, -300]], np.int32)
    got = preprocess.batched_crop256(torch.from_numpy(tile), torch.from_numpy(origins))
    want = np.asarray(jax_pre.batched_crop256(jnp.asarray(tile), jnp.asarray(origins)))
    assert got.shape == (6, 256, 256, 3)
    np.testing.assert_array_equal(got.numpy(), want)  # negative and clamped starts


def test_normalize_crops_matches_jax(rng):
    crops = rng.randint(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    mean = np.array([0.5, 0.4, 0.3], np.float32)
    std = np.array([0.2, 0.25, 0.3], np.float32)
    got = preprocess.normalize_crops(torch.from_numpy(crops), torch.from_numpy(mean),
                                     torch.from_numpy(std))
    want = np.asarray(jax_pre.normalize_crops(jnp.asarray(crops), jnp.asarray(mean),
                                              jnp.asarray(std)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(1536, 1536), (300, 600), (600, 300), (1000, 1536),
                                   (128, 128)])
def test_rescale_from_tile_frame_matches_jax(rng, shape):
    dets = np.concatenate([rng.uniform(-20, 1556, (6, 4)), rng.rand(6, 2),
                           rng.randint(0, 2, (6, 1))], axis=1).astype(np.float32)
    got = boxes.rescale_from_tile_frame(dets, 1536, shape)
    want = jax_boxes.rescale_from_tile_frame(dets, 1536, shape)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("value,n", [(16, 10), ("auto", 63), ("auto", 64), (" AUTO ", 200),
                                     ("8", 5)])
def test_resolve_batch_size_matches_jax(value, n):
    assert resolve_batch_size(value, n) == jax_resolve_batch_size(value, n)


# -- io/datasets ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    write_tile_folder(str(d), np.random.RandomState(1), 5, 128, border=(100, 64))
    return str(d)


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """PNG tiles: not all JPEG, so both packages take the PIL path."""
    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.RandomState(2)
    for i, hw in enumerate([(128, 128), (128, 128), (64, 100), (128, 128)]):
        Image.fromarray(rng.randint(1, 255, hw + (3,)).astype(np.uint8)).save(d / f"p{i}.png")
    (d / "q_bad.png").write_bytes(b"nope")
    return str(d)


def _batches(folder_cls, path, batch_size, **kw):
    ds = folder_cls(path, tile_size=128, **kw)
    return ds, list(ds.iter_batches(batch_size))


@pytest.mark.parametrize("which", ["jpeg", "png"])
@pytest.mark.parametrize("batch_size,resize_to", [(1, None), (2, None), (3, 64), (4, None),
                                                  (8, 40)])
def test_image_folder_matches_jax(jpeg_folder, png_folder, which, batch_size, resize_to):
    path = {"jpeg": jpeg_folder, "png": png_folder}[which]
    ds, got = _batches(datasets.ImageFolder, path, batch_size, resize_to=resize_to)
    jds, want = _batches(jax_datasets.ImageFolder, path, batch_size, resize_to=resize_to)
    assert ds.files == jds.files and len(got) == len(want)
    for (p, b, n), (jp, jb, jn) in zip(got, want):
        assert p == jp and n == jn and b.dtype == jb.dtype == np.uint8
        assert b.shape == (batch_size, resize_to or 128, resize_to or 128, 3)
        np.testing.assert_array_equal(b, jb)
    assert ds.orig_shapes == {k: tuple(v) for k, v in jds.orig_shapes.items()}
    assert sum(n for _, _, n in got) == len(ds.files) - 1  # the corrupt file is skipped


def test_image_folder_uses_the_native_reader_for_jpegs(jpeg_folder, png_folder):
    if not native.available():
        pytest.skip("the tile reader does not build here (no g++ or no libjpeg headers)")
    pool = datasets.ImageFolder(jpeg_folder, tile_size=128)._native_pool()
    assert pool is not None
    pool.close()
    assert datasets.ImageFolder(png_folder, tile_size=128)._native_pool() is None
    assert datasets.ImageFolder(jpeg_folder)._native_pool() is None  # no tile size


def test_border_tile_fills_the_frame(jpeg_folder):
    ds = datasets.ImageFolder(jpeg_folder, tile_size=128)
    i = ds.files.index(f"{jpeg_folder}/u_border.jpg")
    path, img = ds[i]
    jpath, jimg = jax_datasets.ImageFolder(jpeg_folder, tile_size=128)[i]
    assert path == jpath and img.shape == (128, 128, 3)
    np.testing.assert_array_equal(img, jimg)
    assert ds.orig_shapes[path] == (100, 64)
    assert img[:, 0].sum() == 0 and img[:, -1].sum() == 0  # centred: pad columns
    assert img[64, 64].sum() > 0


def test_unreadable_files_are_reported(jpeg_folder, png_folder, capsys):
    for path in (jpeg_folder, png_folder):
        list(datasets.ImageFolder(path, tile_size=128).iter_batches(2))
    out = capsys.readouterr().out
    assert "Could not read image" in out and "c_bad.jpg" in out and "q_bad.png" in out


def test_fast_decode_takes_the_scaled_decode(jpeg_folder):
    if not native.available():
        pytest.skip("the tile reader does not build here (no g++ or no libjpeg headers)")
    ds = datasets.ImageFolder(jpeg_folder, tile_size=128, resize_to=32, fast_decode=True)
    paths, batch, n = next(ds.iter_batches(2))
    pool = native.TilePool(1)
    try:
        want, _, _ = pool.decode_batch(paths, 128, 32, scale_denom=4)  # 128 // 4 >= 32
        full, _, _ = pool.decode_batch(paths, 128, 32)
    finally:
        pool.close()
    np.testing.assert_array_equal(batch, want)
    assert not np.array_equal(batch, full)


@pytest.mark.parametrize("which", ["jpeg", "png"])
def test_abandoned_folder_iterator_joins_producer(jpeg_folder, png_folder, which):
    """Abandoning ``iter_batches`` after one batch stops and joins the
    producer before the cleanup (closing the native pool while a decode is
    in flight corrupts the heap)."""
    path = {"jpeg": jpeg_folder, "png": png_folder}[which]
    ds = datasets.ImageFolder(path, tile_size=128)
    before = set(threading.enumerate())
    it = ds.iter_batches(2, prefetch=1)
    _, batch, _ = next(it)
    assert batch.shape[0] == 2
    it.close()
    leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()]
    assert not leaked, leaked
    assert sum(n for _, _, n in ds.iter_batches(2)) == len(ds.files) - 1


# -- Detector.detect_folder and folder calibration ------------------------------

@pytest.fixture(scope="module")
def det_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("detect")
    write_tile_folder(str(d), np.random.RandomState(3), 5, 256, border=(160, 256), blank=1)
    return str(d)


@pytest.fixture(scope="module")
def params():
    """Weights whose detections on ``det_folder`` mix both classes."""
    return jax_params_np(mini_spec(), 4)


@pytest.fixture(scope="module")
def jax_detector(params):
    return JaxDetector(mini_spec(), params, compute_dtype=jnp.float32, **CFG)


def _port_detector(params, **kw):
    spec = port_mini_spec()
    return Detector(spec, params_from_jax(params, spec), device="cpu",
                    **{**CFG, "compute_dtype": torch.float32, **kw})


def _same_layout(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k] is None) == (want[k] is None), k
        if want[k] is not None:
            assert got[k].shape == want[k].shape, k


def test_detect_folder_matches_jax_before_merge(params, jax_detector, det_folder, capsys):
    want = jax_detector.detect_folder(det_folder, batch_size=3)
    det = _port_detector(params)
    got = det.detect_folder(det_folder, batch_size=3)
    _same_layout(got, want)
    assert f"{det_folder}/c_bad.jpg" not in got
    assert capsys.readouterr().out.count("c_bad.jpg") == 2  # reported by both
    assert sum(v is not None for v in got.values()) >= 4
    for k, w in want.items():
        if w is not None:
            np.testing.assert_allclose(got[k][:, :4], w[:, :4], atol=BOX_ATOL, rtol=0)
            np.testing.assert_allclose(got[k][:, 4:6], w[:, 4:6], atol=SCORE_ATOL, rtol=0)
            np.testing.assert_array_equal(got[k][:, 6], w[:, 6])
    # the border tile comes back in its own 160x256 pixels (its square's
    # top pad, 48 rows, taken off)
    border = got[f"{det_folder}/u_border.jpg"]
    cy = (border[:, 1] + border[:, 3]) / 2
    assert (cy >= -48).all() and (cy <= 160 + 48).all()
    assert (det.images_seen, det.overflow_images) == (jax_detector.images_seen,
                                                      jax_detector.overflow_images)
    assert det.images_seen == 7  # n_valid rows only: 5 + border + blank


def test_detect_folder_merge_and_caa_filter_match_jax(params, jax_detector, det_folder):
    cparams = jax_classifier_params(3, fc_scale=8.0)
    det = _port_detector(params)
    merged = det.detect_folder(det_folder, batch_size=4, merge_boxes=True)
    _same_layout(merged, jax_detector.detect_folder(det_folder, batch_size=4,
                                                    merge_boxes=True))
    want = jax_detector.detect_folder(det_folder, batch_size=4, merge_boxes=True,
                                      caa_filter=JaxCAAFilter(cparams).filter_path)
    caa = CAAFilter(classifier.from_jax_params(cparams), device="cpu")
    got = det.detect_folder(det_folder, batch_size=4, merge_boxes=True,
                            caa_filter=caa.filter_path)
    _same_layout(got, want)
    for k, w in want.items():
        if w is not None:
            np.testing.assert_array_equal(got[k][:, 6], w[:, 6])
            # merged corners are integers (the union's int() casts)
            np.testing.assert_allclose(got[k][:, :4], w[:, :4], atol=1.0, rtol=0)
    caa_rows = [int((v[:, 6] == 0).sum()) for v in merged.values() if v is not None]
    kept = [int((v[:, 6] == 0).sum()) for v in got.values() if v is not None]
    assert 0 < sum(kept) < sum(caa_rows)  # the filter kept some CAA rows, dropped some
    # a filter that drops every row turns each result into None
    drop_all = det.detect_folder(det_folder, batch_size=4, caa_filter=lambda p, d: d[:0])
    assert set(drop_all) == set(want) and all(v is None for v in drop_all.values())


def test_detect_folder_background_skip_matches_jax(params, jax_detector, det_folder):
    want = jax_detector.detect_folder(det_folder, batch_size=8, background_skip=True)
    got = _port_detector(params).detect_folder(det_folder, batch_size=8,
                                               background_skip=True)
    _same_layout(got, want)
    assert got[f"{det_folder}/v_blank0.jpg"] is None  # skipped, present as None


@pytest.mark.parametrize("precision", ["int8_full", "int8_early"])
def test_calibrate_from_folder_matches_jax(params, det_folder, monkeypatch, precision):
    monkeypatch.setattr(Detector, "CALIB_TILES", 5)
    monkeypatch.setattr(JaxDetector, "CALIB_TILES", 5)
    small = {**CFG, "tile_size": 256}
    jd = JaxDetector(mini_spec(), params, precision=precision, **small)
    jds = jax_datasets.ImageFolder(det_folder, tile_size=256)
    jd._calibrate_from_folder(jds, 2)
    det = _port_detector(params, precision=precision, compute_dtype=torch.bfloat16)
    det._calibrate_from_folder(datasets.ImageFolder(det_folder, tile_size=256), 2)
    assert det._calib_meta == jd._calib_meta
    assert det._calib_meta["n_tiles"] == 5
    assert det._calib_meta["first_tiles"] == ["t000.jpg", "t001.jpg", "t002.jpg", "t003.jpg"]
    assert sorted(det._act_scales) == sorted(jd._act_scales)
    for k, v in jd._act_scales.items():
        np.testing.assert_allclose(det._act_scales[k], v, rtol=1e-6, err_msg=k)


def test_detect_folder_int8_full_calibrates_from_the_folder(params, det_folder, tmp_path):
    """An uncalibrated int8 Detector calibrates on the folder's tiles (all
    7 readable ones, fewer than CALIB_TILES) and records them."""
    det = _port_detector(params, precision="int8_full", compute_dtype=torch.bfloat16)
    got = det.detect_folder(det_folder, batch_size=4)
    assert len(got) == 7 and det._act_scales is not None
    import json

    with open(det.save_calibration(str(tmp_path / "c.json"))) as fh:
        meta = json.load(fh)["meta"]
    assert meta["source"] == "folder" and meta["n_tiles"] == 7


@pytest.mark.parametrize("depth", [0, 1, 5])
def test_pipeline_depth_leaves_results_unchanged(params, det_folder, depth):
    """Batches in flight change when the host drains, not what it returns."""
    det = _port_detector(params)
    want = det.detect_folder(det_folder, batch_size=2, merge_boxes=True)
    got = det.detect_folder(det_folder, batch_size=2, merge_boxes=True, pipeline_depth=depth)
    _same_layout(got, want)
    for k, w in want.items():
        if w is not None:
            np.testing.assert_array_equal(got[k], w)
