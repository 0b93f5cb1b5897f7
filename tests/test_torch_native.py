"""The port's native tile reader (``csrc/tile_reader.cc`` through
``io/native.py``): its source against the JAX package's, its decodes against
PIL (bit-equal, as ``test_native_reader_parity_if_available`` asserts for
the JAX package's library), and the robustness battery of
``test_native_fuzz.py`` on the port's own build.  Every test that needs the
library skips only where ``g++`` or the libjpeg headers are absent."""

import ctypes
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from amyloid_yolo_tpu.ops.preprocess import nearest_indices as jax_nearest_indices
from amyloid_yolo_tpu_torch.io import native
from amyloid_yolo_tpu_torch.io.datasets import load_image_rgb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 512


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("the tile reader does not build here (no g++ or no libjpeg headers)")
    return native._load()


@pytest.fixture(scope="module")
def valid_jpeg():
    rng = np.random.RandomState(7)
    buf = io.BytesIO()
    Image.fromarray(rng.randint(0, 255, (SIDE, SIDE, 3)).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiles")
    rng = np.random.RandomState(0)
    paths = []
    for i in range(5):
        p = str(d / f"t{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (256, 256, 3)).astype(np.uint8)).save(p)
        paths.append(p)
    (d / "bad.jpg").write_bytes(b"nope")
    border = str(d / "border.jpg")
    Image.fromarray(np.full((100, 64, 3), 200, np.uint8)).save(border, quality=95)
    return paths, str(d / "bad.jpg"), border


def _code(path):
    """The C++ lines of a source without comments or blank lines."""
    with open(path) as fh:
        lines = [re.sub(r"\s*//.*$", "", l).rstrip() for l in fh]
    return [l for l in lines if l]


def test_source_is_a_copy_of_the_references():
    jax_src = os.path.join(REPO, "amyloid_yolo_tpu", "runtime", "tile_reader.cc")
    assert _code(native.SOURCE) == _code(jax_src)
    for name in ("tile_pool_create", "tile_pool_destroy", "tile_pool_decode_batch",
                 "tile_decode_one", "tile_decode_mem"):
        assert any(name + "(" in l for l in _code(native.SOURCE)), name


def test_library_is_keyed_on_the_source(monkeypatch, tmp_path):
    """An edited source builds a new library."""
    edited = tmp_path / "tile_reader.cc"
    edited.write_text(open(native.SOURCE).read() + "\n// edited\n")
    before = native.library_path()
    monkeypatch.setattr(native, "SOURCE", str(edited))
    assert native.library_path() != before


def test_decode_batch_bit_equal_to_pil(lib, tiles):
    paths, bad, _ = tiles
    pool = native.TilePool(2)
    try:
        batch, ok, dims = pool.decode_batch(paths + [bad], tile_size=256, resize_to=0)
        assert ok.tolist() == [True] * len(paths) + [False]  # corrupt: flagged, not fatal
        assert dims[:len(paths)].tolist() == [[256, 256]] * len(paths)
        for p, arr in zip(paths, batch):
            np.testing.assert_array_equal(arr, load_image_rgb(p))
    finally:
        pool.close()


@pytest.mark.parametrize("resize_to", [64, 100, 255])
def test_decode_batch_gather_matches_nearest_indices(lib, tiles, resize_to):
    paths, _, _ = tiles
    pool = native.TilePool(1)
    try:
        batch, ok, _ = pool.decode_batch(paths[:2], 256, resize_to)
    finally:
        pool.close()
    assert ok.all() and batch.shape == (2, resize_to, resize_to, 3)
    idx = jax_nearest_indices(resize_to, 256)
    for p, arr in zip(paths, batch):
        np.testing.assert_array_equal(arr, load_image_rgb(p)[idx][:, idx])


def test_decode_batch_reports_border_dims(lib, tiles):
    _, _, border = tiles
    pool = native.TilePool(1)
    try:
        batch, ok, dims = pool.decode_batch([border], 128, 0)
    finally:
        pool.close()
    assert ok[0] and tuple(dims[0]) == (100, 64) and batch.shape == (1, 128, 128, 3)
    img = load_image_rgb(border)
    np.testing.assert_array_equal(batch[0, :100, :64], img)  # top-left, zero-filled
    assert batch[0, 100:].sum() == 0 and batch[0, :, 64:].sum() == 0


def test_pool_refuses_use_after_close(lib, tiles):
    pool = native.TilePool(1)
    pool.close()
    pool.close()
    with pytest.raises(RuntimeError):
        pool.decode_batch(tiles[0][:1], 256)


def test_decode_one(lib, tiles):
    paths, bad, border = tiles
    np.testing.assert_array_equal(native.decode_one(paths[0], 256, 256),
                                  load_image_rgb(paths[0]))
    framed = native.decode_one(border, 160, 160)
    np.testing.assert_array_equal(framed[:100, :64], load_image_rgb(border))
    assert framed[100:].sum() == 0 and framed[:, 64:].sum() == 0
    assert native.decode_one(bad, 256, 256) is None


def test_decode_tile_bytes(lib, valid_jpeg):
    ref = np.asarray(Image.open(io.BytesIO(valid_jpeg)).convert("RGB"))
    img, dims = native.decode_tile_bytes(valid_jpeg, SIDE)
    assert dims == (SIDE, SIDE)
    np.testing.assert_array_equal(img, ref)
    small, _ = native.decode_tile_bytes(valid_jpeg, SIDE, resize_to=96)
    idx = jax_nearest_indices(96, SIDE)
    np.testing.assert_array_equal(small, ref[idx][:, idx])
    scaled, _ = native.decode_tile_bytes(valid_jpeg, SIDE, resize_to=96, scale_denom=4)
    assert scaled.shape == (96, 96, 3)  # the DCT-scaled rendition: not bit-equal
    assert native.decode_tile_bytes(valid_jpeg, SIDE * 2) is None  # wrong geometry
    assert native.decode_tile_bytes(b"not a jpeg", SIDE) is None


# -- the robustness battery of tests/test_native_fuzz.py, on the port's build --

def _decode_mem(lib, data: bytes, tile=SIDE, resize=0, denom=1):
    side = resize or tile
    out = np.empty((side, side, 3), np.uint8)
    sh, sw = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.tile_decode_mem(data, ctypes.c_ulong(len(data)),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                             tile, resize, denom, ctypes.byref(sh), ctypes.byref(sw))
    return rc, out


def _rss_kb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGESIZE") // 1024


def test_truncations_do_not_crash(lib, valid_jpeg):
    n = len(valid_jpeg)
    for frac in range(1, 50):
        rc, _ = _decode_mem(lib, valid_jpeg[:max(1, n * frac // 50)])
        assert rc in (0, 1, 2, 3)


def test_bitflips_do_not_crash(lib, valid_jpeg):
    rng = np.random.RandomState(0)
    data = bytearray(valid_jpeg)
    for _ in range(200):
        pos = int(rng.randint(0, len(data)))
        old = data[pos]
        data[pos] = int(rng.randint(0, 256))
        rc, _ = _decode_mem(lib, bytes(data))
        assert rc in (0, 1, 2, 3)
        data[pos] = old


def test_garbage_inputs_rejected(lib):
    rng = np.random.RandomState(1)
    assert _decode_mem(lib, b"")[0] != 0
    assert _decode_mem(lib, b"\xff\xd8")[0] != 0
    assert _decode_mem(lib, b"not a jpeg at all")[0] != 0
    for size in (16, 256, 4096):
        assert _decode_mem(lib, rng.bytes(size))[0] != 0


def test_wrong_geometry_rejected_cheaply(lib, valid_jpeg):
    assert _decode_mem(lib, valid_jpeg, tile=SIDE * 2)[0] == 3


def test_corrupt_decode_memory_bound(lib, valid_jpeg):
    """Thousands of corrupt decodes must not grow the resident set."""
    n = len(valid_jpeg)
    rng = np.random.RandomState(2)
    payloads = [valid_jpeg[:max(1, n * f // 17)] for f in range(1, 17)]
    data = bytearray(valid_jpeg)
    for _ in range(16):
        data[int(rng.randint(2, n))] ^= 0xFF
        payloads.append(bytes(data))
    for p in payloads:
        _decode_mem(lib, p)
    rss0 = _rss_kb()
    for i in range(3000):
        _decode_mem(lib, payloads[i % len(payloads)])
    growth = _rss_kb() - rss0
    # a scanline-buffer leak per corrupt decode would be >= 4.5 MB here
    assert growth < 3000, f"RSS grew {growth} KB over 3000 corrupt decodes"


def test_pool_batch_mixed_statuses(lib, valid_jpeg, tmp_path):
    good = tmp_path / "good.jpg"
    good.write_bytes(valid_jpeg)
    trunc = tmp_path / "trunc.jpg"
    trunc.write_bytes(valid_jpeg[:len(valid_jpeg) // 20])
    garbage = tmp_path / "garbage.jpg"
    garbage.write_bytes(b"\x00" * 1000)
    paths = [str(good), str(garbage), str(tmp_path / "missing.jpg"), str(good), str(trunc)]
    pool = native.TilePool(2)
    try:
        out, ok, _ = pool.decode_batch(paths, SIDE, 0)
    finally:
        pool.close()
    ref = np.asarray(Image.open(io.BytesIO(valid_jpeg)).convert("RGB"))
    assert ok[0] and ok[3] and not ok[1] and not ok[2]
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[3], ref)
