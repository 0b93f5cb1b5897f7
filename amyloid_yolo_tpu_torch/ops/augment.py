"""Training augmentation on the device (reference package ``ops/augment.py``).

The policy of the reference's ``augment_batch`` (``ops/augment.py:355-420``,
a port of the imgaug policy of ``utils/augmentations.py:4-22``), per image
and in this order:

1. pixel dropout at a rate ~U[0, 0.01];
2. sharpen, alpha ~U[0, 0.2];
3. affine: rotation ~U[−20°, 20°] about the centre, translation ~U[−20%,
   20%], resampled with the Paeth 3-shear decomposition (three chained 1-D
   lerps, zero outside; ``_affine_shear3``, ``:207-235``);
4. brightness ±30/255, clipped to [0, 1];
5. hue ±20 OpenCV units through HSV;
6. horizontal flip, p = 0.5.

Boxes follow the affine (four corners, re-boxed and clipped,
``_affine_boxes``) and the flip; a box clipped to nothing leaves the
target mask (``alive``).

The exact 2-D warp that the three shears approximate, bilinear with zeros
outside (:func:`_affine_one` over :func:`_bilinear_sample`, reference
``:81-121``), is kept beside them, off ``augment_batch``'s path as in the
reference: the tests hold the shear warp against it (equal for pure
translation), and ``tools/bench_trainstep_torch.py --warp-ab`` times it.

``jax.random``'s streams cannot be reproduced in PyTorch, so the port is in
two parts: :func:`draw_augment_params` makes the eight draws of
``:373-381`` (same distributions) from a ``torch.Generator``, and
:func:`augment_batch` applies the ops to given draws.  The reference's
16-row grouping of each shear pass (``_shear_rows``, ``:168-204``) is a TPU
layout device with the same result as the per-row resample done here.

Images are float32 in [0, 1], NHWC, or with ``layout="planar"`` contiguous
(B, 3, H, W): the reference's planar pipeline (``:238-406``), whose
``_shear_rows_planar``, ``_affine_shear3_planar`` and ``_sharpen_planar``
are the helpers below with ``planar=True``; ``_rgb_to_hsv`` and
``_hsv_to_rgb`` take planes in either layout (its ``_rgb_to_hsv_planes``,
``_hsv_to_rgb_planes``).  The draws do not depend on the layout, and
neither do the results: each op does the same arithmetic on each pixel.
Every op is batched over images with per-image parameters, and nothing
synchronises with the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Draws = Dict[str, torch.Tensor]

SHARPEN_KERNEL = ((-1.0, -1.0, -1.0), (-1.0, 9.0, -1.0), (-1.0, -1.0, -1.0))


def draw_augment_params(generator: torch.Generator, batch: int, size: int,
                        device) -> Draws:
    """The policy's random draws for ``batch`` images of ``size``²: uniform
    draws scaled to each range, the flip a Bernoulli(0.5) as ``u < 0.5``."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {
        "drop_rate": u(batch) * 0.01,
        "sharp_alpha": u(batch) * 0.2,
        "angle": u(batch) * 40.0 - 20.0,
        "trans": u(batch, 2) * 0.4 - 0.2,
        "bright": (u(batch) * 60.0 - 30.0) / 255.0,
        "hue": (u(batch) * 40.0 - 20.0) * 2.0 / 360.0,
        "flip": u(batch) < 0.5,
        "drop_u": u(batch, size, size),
    }


def _rgb_to_hsv(r, g, b):
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    spread = maxc - minc
    s = torch.where(maxc > 0, spread / maxc.clamp(min=1e-12), 0.0)
    safe = spread.clamp(min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(spread == 0, 0.0, h)
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):  # vals[k] where i == k
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return select(v, q, p, p, t, v), select(t, v, v, q, p, p), select(p, p, t, v, v, q)


def _sharpen(img: torch.Tensor, alpha: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """``(1 − α)·img + α·(img ⊛ SHARPEN_KERNEL)`` per channel, zero padded.
    The nine taps are summed elementwise, not by a convolution, so the card
    runs them in float32 whatever cuDNN's TF32 setting."""
    h, w = img.shape[-2:] if planar else img.shape[1:3]
    pad = F.pad(img, (1, 1, 1, 1) if planar else (0, 0, 1, 1, 1, 1))
    sharp = None
    for di in range(3):
        for dj in range(3):
            win = pad[..., di:di + h, dj:dj + w] if planar else pad[:, di:di + h, dj:dj + w]
            tap = SHARPEN_KERNEL[di][dj] * win
            sharp = tap if sharp is None else sharp + tap
    a = alpha[:, None, None, None]
    return (1 - a) * img + a * sharp


def _bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     planar: bool = False) -> torch.Tensor:
    """Sample each image of ``img`` (B, H, W, C), or (B, C, H, W) with
    ``planar``, at the float coordinates ``ys``, ``xs`` (B, h, w): four
    corner gathers weighted bilinearly, a corner outside the image counts
    zero (reference ``_bilinear_sample``, batched)."""
    bsz = img.shape[0]
    (c, h, w) = img.shape[1:] if planar else (img.shape[3], *img.shape[1:3])
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0, xs - x0
    y0i, x0i = y0.long(), x0.long()
    flat = img.reshape(bsz, c, h * w) if planar else img.reshape(bsz, h * w, c)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(bsz, -1)
        if planar:
            vals = torch.gather(flat, 2, idx[:, None, :].expand(-1, c, -1))
            return torch.where(inb[:, None], vals.reshape(bsz, c, *ys.shape[1:]), 0.0)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(inb[..., None], vals.reshape(*ys.shape, c), 0.0)

    if planar:  # the weights broadcast over the channels
        wy, wx = wy[:, None], wx[:, None]
    else:
        wy, wx = wy[..., None], wx[..., None]
    top = gather(y0i, x0i) * (1 - wx) + gather(y0i, x0i + 1) * wx
    bot = gather(y0i + 1, x0i) * (1 - wx) + gather(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def _affine_coords(s: int, angle_deg: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inverse map of :func:`_affine_one`: for each output pixel of an
    s² image, its source ``(ys, xs)``, each (B, s, s).  The cosine and sine
    are taken in float64 and rounded to float32, so that the card and the
    CPU map every pixel alike: their float32 ``cos``/``sin`` may differ by
    an ulp, which moves a sample by up to ~2e-5 px and a pixel at the
    zero-filled border by as much."""
    c = (s - 1) / 2.0
    th = torch.deg2rad(angle_deg)[:, None, None].to(torch.float64)
    cos, sin = torch.cos(th).to(torch.float32), torch.sin(th).to(torch.float32)
    r = torch.arange(s, dtype=torch.float32, device=angle_deg.device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    ox = gx - c - tx[:, None, None] * s
    oy = gy - c - ty[:, None, None] * s
    return -sin * ox + cos * oy + c, cos * ox + sin * oy + c


def _affine_one(img: torch.Tensor, angle_deg: torch.Tensor, tx: torch.Tensor,
                ty: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """Rotate each image about its centre by ``angle_deg`` and translate by
    (tx, ty)·size with the exact inverse map (:func:`_affine_coords`),
    bilinear, zeros outside (reference ``_affine_one``, one image there, a
    batch here: ``angle_deg``, ``tx``, ``ty`` are (B,))."""
    s = img.shape[2] if planar else img.shape[1]
    return _bilinear_sample(img, *_affine_coords(s, angle_deg, tx, ty), planar)


def _shear_rows(img: torch.Tensor, shift: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """Resample each row at ``x + shift[b, row]``: a 2-tap lerp with zeros
    outside.  ``img`` (B, H, W, C), or (B, C, H, W) with ``planar``;
    ``shift`` (B, H)."""
    w = img.shape[-1] if planar else img.shape[2]
    k = torch.floor(shift)
    f = (shift - k)[..., None]
    i0 = torch.arange(w, device=img.device)[None, None, :] + k.long()[..., None]
    if planar:  # (B, 1, H, W) over the channels
        f, i0 = f[:, None], i0[:, None]
    else:       # (B, H, W, 1)
        f, i0 = f[..., None], i0[..., None]
    dim = 3 if planar else 2

    def tap(idx):
        inside = (idx >= 0) & (idx < w)
        v = torch.gather(img, dim, idx.clamp(0, w - 1).expand_as(img))
        return torch.where(inside, v, 0.0)

    return (1.0 - f) * tap(i0) + f * tap(i0 + 1)


def _affine_shear3(img: torch.Tensor, angle_deg: torch.Tensor, tx: torch.Tensor,
                   ty: torch.Tensor, planar: bool = False) -> torch.Tensor:
    """Rotate each image about its centre by ``angle_deg`` and translate by
    (tx, ty)·size, as three shear passes (x, y, x); the constants make the
    composition the exact inverse map of the 2-D warp (reference
    ``_affine_shear3``'s derivation)."""
    s = img.shape[2] if planar else img.shape[1]
    hw = (2, 3) if planar else (1, 2)
    c = (s - 1) / 2.0
    th = torch.deg2rad(angle_deg)[:, None]
    cos, sin = torch.cos(th), torch.sin(th)
    t2 = torch.tan(th / 2.0)
    tx_, ty_ = tx[:, None] * s, ty[:, None] * s
    c1 = c - cos * (c + tx_) - sin * (c + ty_)
    c2 = c + sin * (c + tx_) - cos * (c + ty_)
    d3 = -t2 * c
    d2 = c2 + sin * d3
    d1 = c1 - d3 - t2 * c2
    idx = torch.arange(s, dtype=torch.float32, device=img.device)[None, :]
    out = _shear_rows(img, t2 * idx + d1, planar)                                  # x
    out = _shear_rows(out.transpose(*hw), -sin * idx + d2, planar).transpose(*hw)  # y
    return _shear_rows(out, t2 * idx + d3, planar)                                 # x


def _affine_boxes(boxes: torch.Tensor, angle_deg: torch.Tensor, tx: torch.Tensor,
                  ty: torch.Tensor) -> torch.Tensor:
    """Normalized (cx, cy, w, h) boxes through the forward affine: the four
    corners rotated about the centre and translated, re-boxed, clipped to
    the image (imgaug's box policy)."""
    th = torch.deg2rad(angle_deg)
    cos, sin = torch.cos(th)[:, None], torch.sin(th)[:, None]
    cx, cy, w, h = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    dx = torch.stack([-w / 2, w / 2, -w / 2, w / 2], dim=-1)
    dy = torch.stack([-h / 2, -h / 2, h / 2, h / 2], dim=-1)
    px = cx[:, None] + dx - 0.5
    py = cy[:, None] + dy - 0.5
    qx = cos * px - sin * py + 0.5 + tx[:, None]
    qy = sin * px + cos * py + 0.5 + ty[:, None]
    x1 = qx.amin(dim=-1).clamp(0.0, 1.0)
    x2 = qx.amax(dim=-1).clamp(0.0, 1.0)
    y1 = qy.amin(dim=-1).clamp(0.0, 1.0)
    y2 = qy.amax(dim=-1).clamp(0.0, 1.0)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def augment_batch(images: torch.Tensor, targets: torch.Tensor,
                  target_mask: torch.Tensor, draws: Draws, layout: str = "nhwc"
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply the policy with ``draws`` (:func:`draw_augment_params`) to
    ``images`` (B, S, S, 3) float32 in [0, 1] — (B, 3, S, S) with
    ``layout="planar"`` — and the padded targets (T, 6) rows
    ``(batch_idx, class, cx, cy, w, h)``; returns (images, targets,
    target_mask)."""
    planar = layout == "planar"
    bsz = images.shape[0]
    per_image = (slice(None), None, None, None)
    drop_u = draws["drop_u"][:, None] if planar else draws["drop_u"][..., None]
    img = torch.where(drop_u < draws["drop_rate"][per_image], 0.0, images)        # dropout
    img = _sharpen(img, draws["sharp_alpha"], planar)                            # sharpen
    angle, trans = draws["angle"], draws["trans"]
    img = _affine_shear3(img, angle, trans[:, 0], trans[:, 1], planar)           # affine
    img = torch.clamp(img + draws["bright"][per_image], 0.0, 1.0)                # brightness
    img = torch.clamp(img, 0.0, 1.0)                                             # hue
    cdim = 1 if planar else 3
    h, s, v = _rgb_to_hsv(*img.unbind(cdim))
    h = torch.remainder(h + draws["hue"][:, None, None], 1.0)
    img = torch.stack(_hsv_to_rgb(h, s, v), dim=cdim)
    flip = draws["flip"]
    img = torch.where(flip[per_image], img.flip(3 if planar else 2), img)        # flip

    bidx = targets[:, 0].long().clamp(0, bsz - 1)
    box = _affine_boxes(targets[:, 2:6], angle[bidx], trans[bidx, 0], trans[bidx, 1])
    cx = torch.where(flip[bidx], 1.0 - box[:, 0], box[:, 0])
    new_t = torch.cat([targets[:, :2], cx[:, None], box[:, 1:]], dim=1)
    alive = (box[:, 2] > 1e-6) & (box[:, 3] > 1e-6)
    return img, new_t, target_mask & alive


__all__ = ["draw_augment_params", "augment_batch"]
