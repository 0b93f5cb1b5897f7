"""Port ``io/tissue.py`` against the JAX package's: the same fractions and
the same skip decisions, exactly, on the same images and files."""

import os

import numpy as np
import pytest
from PIL import Image

from amyloid_yolo_tpu.io import tissue as jax_tissue
from amyloid_yolo_tpu_torch.io import tissue


def _save(tmp_path, name, arr, quality=90):
    p = str(tmp_path / name)
    Image.fromarray(arr).save(p, quality=quality)
    return p


def _blank(side=512, value=245):
    return np.full((side, side, 3), value, np.uint8)


def _scanner_background(side=512):
    """Smooth off-white with a gentle illumination gradient."""
    yy, xx = np.mgrid[0:side, 0:side]
    base = 242 + 6 * np.sin(yy / side * 3.1) + 4 * np.cos(xx / side * 2.7)
    return np.clip(np.stack([base, base, base - 2], -1), 0, 255).astype(np.uint8)


def _tissue(side=512, seed=1, coverage=0.5):
    """Tan/brown stained blobs over scanner background."""
    rng = np.random.RandomState(seed)
    img = _scanner_background(side)
    yy, xx = np.mgrid[0:side, 0:side]
    for _ in range(max(1, int(coverage * 24))):
        cy, cx = rng.randint(0, side, 2)
        r = rng.randint(side // 10, side // 4)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = [
            rng.randint(120, 190), rng.randint(90, 150), rng.randint(60, 120)]
    return img


def test_thresholds_are_the_references():
    for name in ("BACKGROUND_MAX_BPP", "TISSUE_MIN_FRACTION", "BG_MIN_BRIGHTNESS",
                 "BG_MAX_CHROMA"):
        assert getattr(tissue, name) == getattr(jax_tissue, name), name


@pytest.mark.parametrize("kind", ["blank", "scanner", "tissue", "noise"])
@pytest.mark.parametrize("subsample", [1, 4])
def test_tissue_fraction_matches_jax(kind, subsample):
    img = {"blank": _blank(), "scanner": _scanner_background(),
           "tissue": _tissue(coverage=0.8),
           "noise": np.random.RandomState(3).randint(150, 256, (300, 200, 3)).astype(np.uint8)
           }[kind]
    got = tissue.tissue_fraction(img, subsample)
    assert got == jax_tissue.tissue_fraction(img, subsample)
    if kind == "blank":
        assert got == 0.0
    if kind == "tissue":
        assert got > 0.2


def test_two_stage_prefilter_matches_jax(tmp_path):
    bg = _save(tmp_path, "bg.jpg", _scanner_background())
    blank = _save(tmp_path, "blank.jpg", _blank())
    dense = _save(tmp_path, "tissue.jpg", _tissue(coverage=0.8))
    faint = _scanner_background()
    faint[200:320, 200:320] = [150, 120, 90]  # small on disk, but tissue
    faint_p = _save(tmp_path, "faint.jpg", faint)
    broken = str(tmp_path / "broken.jpg")
    with open(broken, "wb") as fh:
        fh.write(b"nope")
    assert os.path.getsize(faint_p) < tissue.BACKGROUND_MAX_BPP * 512 * 512, \
        "the fixture must reach stage 2"
    paths = [bg, blank, dense, faint_p, broken]
    for p in paths:
        assert tissue.is_background_file(p) == jax_tissue.is_background_file(p), p
    kept, skipped = tissue.prefilter_tile_paths(paths)
    assert (kept, skipped) == jax_tissue.prefilter_tile_paths(paths)
    assert set(kept) == {dense, faint_p, broken}  # unreadable: not background
    assert set(skipped) == {bg, blank}


@pytest.mark.parametrize("max_bpp,min_tissue", [(0.2, 0.02), (0.05, 0.5), (0.0, 0.02)])
def test_prefilter_thresholds_match_jax(tmp_path, max_bpp, min_tissue):
    paths = [_save(tmp_path, f"t{i}.jpg", _tissue(256, seed=i, coverage=c))
             for i, c in enumerate((0.05, 0.2, 0.5))]
    paths.append(_save(tmp_path, "bg.jpg", _scanner_background(256)))
    assert (tissue.prefilter_tile_paths(paths, max_bpp, min_tissue)
            == jax_tissue.prefilter_tile_paths(paths, max_bpp, min_tissue))
