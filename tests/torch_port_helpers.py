"""Shared fixtures of the PyTorch-port parity tests (``test_torch_*.py``).

``port_mini_spec`` builds ``minispec.mini_spec``'s graph with the port's own
builder; ``jax_params_np`` makes JAX reference-scheme weights and hands them
over as numpy, the form both packages take.  The folder path's tests write
synthetic stain tiles (``stain_tile``, ``write_tile_folder``) and take the
CAA classifier's weights from ``jax_classifier_params``.
"""

import jax
import numpy as np

from amyloid_yolo_tpu.models import classifier as jax_classifier
from amyloid_yolo_tpu.models import darknet as jax_darknet
from amyloid_yolo_tpu_torch.graphspec import NetInfo, YOLOV3_MASKS, _Builder, _finish


def port_mini_spec(num_classes: int = 2, img_size: int = 64):
    """``tests/minispec.py:mini_spec`` through the port's ``_Builder``."""
    b = _Builder(NetInfo(width=img_size, height=img_size))
    hf = 3 * (5 + num_classes)

    def res(f):
        b.conv(f // 2, 1)
        b.conv(f, 3)
        b.shortcut(-3)

    b.conv(4, 3)
    b.conv(8, 3, stride=2)
    res(8)
    b.conv(16, 3, stride=2)
    res(16)
    r8 = b.i - 1
    b.conv(32, 3, stride=2)
    res(32)
    r16 = b.i - 1
    b.conv(64, 3, stride=2)
    res(64)

    b.conv(32, 1)
    b.conv(64, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[0], num_classes)

    b.route([-4])
    b.conv(16, 1)
    b.upsample(2)
    b.route([-1, r16])
    b.conv(16, 1)
    b.conv(32, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[1], num_classes)

    b.route([-4])
    b.conv(8, 1)
    b.upsample(2)
    b.route([-1, r8])
    b.conv(8, 1)
    b.conv(16, 3)
    b.conv(hf, 1, bn=False, act="linear")
    b.yolo(YOLOV3_MASKS[2], num_classes)
    return _finish(b.net, b.layers, b.out_channels)


def jax_params_np(spec, seed: int, bn_noise: bool = False, jit: bool = False):
    """JAX ``init_params`` weights as numpy.  ``bn_noise`` randomises the BN
    shift and running stats (numpy seed ``seed``) so folding is exercised.
    ``jit`` runs ``init_params`` compiled: one program instead of one eager
    compile per random draw (~15 s on a cold cache for the mini spec), with
    draws that differ from the eager ones in the last bits."""
    init = jax.jit(jax_darknet.init_params, static_argnums=1) if jit else jax_darknet.init_params
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), spec))
    if bn_noise:
        rng = np.random.RandomState(seed)
        for k, v in params.items():
            if k.startswith("bn_"):
                n = v["bias"].shape[0]
                v["bias"] = (0.1 * rng.randn(n)).astype(np.float32)
                v["mean"] = (0.1 * rng.randn(n)).astype(np.float32)
                v["var"] = (0.5 + rng.rand(n)).astype(np.float32)
    return params


def stain_tile(rng, h: int, w: int) -> np.ndarray:
    """A smooth synthetic stained-tissue tile (uint8 HWC): dark blobs of
    stain over a bright background, with a little grain, so JPEG sizes and
    detections look like a real tile's rather than uniform noise's."""
    yy, xx = np.mgrid[0:h, 0:w] / float(max(h, w))
    img = np.full((h, w, 3), 236.0)
    for _ in range(8):
        cy, cx = rng.rand(2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / rng.uniform(0.002, 0.03))
        img -= blob[..., None] * rng.uniform([50, 80, 100], [110, 150, 170])
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_tile_folder(folder, rng, n: int, side: int, border=None, blank: int = 0,
                      corrupt: bool = True):
    """``n`` JPEG tiles ``t000.jpg``… of ``side``², a ``border`` (h, w) tile
    ``u_border.jpg``, ``blank`` near-blank tiles ``v_blank*.jpg`` and a
    corrupt ``c_bad.jpg``; returns the readable paths, sorted."""
    import os

    from PIL import Image

    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n):
        paths.append(os.path.join(folder, f"t{i:03d}.jpg"))
        Image.fromarray(stain_tile(rng, side, side)).save(paths[-1], quality=90)
    if border is not None:
        paths.append(os.path.join(folder, "u_border.jpg"))
        Image.fromarray(stain_tile(rng, *border)).save(paths[-1], quality=90)
    for i in range(blank):
        paths.append(os.path.join(folder, f"v_blank{i}.jpg"))
        img = np.full((side, side, 3), 243, np.uint8) + rng.randint(0, 3, (side, side, 1)).astype(np.uint8)
        Image.fromarray(img).save(paths[-1], quality=90)
    if corrupt:
        with open(os.path.join(folder, "c_bad.jpg"), "wb") as fh:
            fh.write(b"not a jpeg")
    return sorted(paths)


def stain_crops(seed: int, n: int = 6) -> np.ndarray:
    """(n, 256, 256, 3) uint8 crops of a synthetic stained tile."""
    rng = np.random.RandomState(seed)
    img = stain_tile(rng, 768, 768)
    xy = rng.randint(0, 512, (n, 2))
    return np.stack([img[y:y + 256, x:x + 256] for x, y in xy])


def jax_classifier_params(seed: int, fc_scale: float = 1.0, jit: bool = False):
    """JAX ``init_params`` as numpy, with random BN statistics, the linear
    layer scaled by ``fc_scale`` and its bias set so the median logit of
    some stain crops is 0: probabilities then fall on both sides of 0.5
    (unscaled random weights put them all near one value).  ``jit`` runs
    the probe compiled (~1 s instead of ~5 s of eager compiles), with a
    bias that differs from the eager one in the last bits."""
    p = jax.tree.map(np.asarray, jax_classifier.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    for i, w in enumerate(jax_classifier.STAGE_WIDTHS):
        p[f"conv_{i}"]["b"] = (0.05 * rng.randn(w)).astype(np.float32)
        p[f"bn_{i}"] = {"scale": (1 + 0.1 * rng.randn(w)).astype(np.float32),
                        "bias": (0.1 * rng.randn(w)).astype(np.float32),
                        "mean": (0.05 * rng.randn(w)).astype(np.float32),
                        "var": (0.5 + rng.rand(w)).astype(np.float32)}
    p["fc"]["w"] = (p["fc"]["w"] * fc_scale).astype(np.float32)
    probe = stain_crops(1000 + seed, 8).astype(np.float32) / 255.0
    apply = jax.jit(jax_classifier.apply) if jit else jax_classifier.apply
    logits = np.asarray(apply(p, probe))
    p["fc"]["b"] = (-np.median(logits, axis=0)).astype(np.float32)
    return p


def copy_always(monkeypatch, *modules):
    """Make every move between the devices of a mesh a real copy, as it is
    across cards; returns the list the copies are counted into."""
    moved = []

    def copy(t, device):
        moved.append(t.numel())
        return t.to(device, copy=True)

    for mod in modules:
        monkeypatch.setattr(mod, "to_device", copy)
    return moved


def low_dpi_figures(monkeypatch, dpi: int = 20):
    """Make matplotlib save every figure at ``dpi``: the study's figures ask
    for 300, which costs ~0.3 s a PNG, and the parity tests compare the
    files' names and the returned numbers, not the pixels."""
    from matplotlib.figure import Figure

    save = Figure.savefig
    monkeypatch.setattr(Figure, "savefig", lambda self, *a, **kw: save(self, *a, **{**kw, "dpi": dpi}))
