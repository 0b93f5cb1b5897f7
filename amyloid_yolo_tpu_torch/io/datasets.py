"""Folder inference stream: a sorted folder of tiles as padded uint8 batches.

Counterpart of the reference package's ``io/datasets.py:46-268``
(``load_image_rgb``, ``pad_to_square_np``, ``ImageFolder``); the training
``ListDataset`` is not ported yet.  Tiles stay uint8 at tile resolution on
the host; the resize and scale run on the device (K1).  A producer thread
decodes ahead of the consumer: the native pool (:mod:`.native`) when the
folder is all JPEG and a tile size is declared and the library is built,
PIL otherwise.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..ops.preprocess import nearest_indices, pad_amounts

try:  # PIL is the fallback decoder; the native pool is preferred
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    _HAVE_PIL = True
except ImportError:  # pragma: no cover
    _HAVE_PIL = False


def load_image_rgb(path: str) -> np.ndarray:
    """Decode one image to HWC uint8 RGB."""
    if not _HAVE_PIL:  # pragma: no cover
        raise RuntimeError("PIL unavailable and no native decoder built")
    return np.array(Image.open(path).convert("RGB"), dtype=np.uint8)


def pad_to_square_np(img: np.ndarray, pad_value: int = 0
                     ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Host uint8 centre pad; returns (img, (left, right, top, bottom))."""
    h, w = img.shape[:2]
    l, r, t, b = pad_amounts(h, w)
    if l or r or t or b:
        img = np.pad(img, ((t, b), (l, r), (0, 0)), constant_values=pad_value)
    return img, (l, r, t, b)


def _consume_prefetched(q: "queue.Queue", t: threading.Thread,
                        stop: threading.Event):
    """Yield what a producer thread puts on ``q`` (None = end, an exception
    = re-raise), and on ANY exit (end of stream, a consumer's break, an
    abandoned generator) set ``stop`` and drain until the producer has
    finished.

    The drain matters: without it a consumer that abandons the generator
    early would run the cleanup while the producer is still inside native
    code (destroying the C++ TilePool in the middle of ``decode_batch``
    corrupts the heap), or leave a producer blocked on ``q.put`` for ever.
    """
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while t.is_alive():
            try:
                q.get(timeout=0.05)
            except queue.Empty:
                pass


class ImageFolder:
    """Sorted folder of images, yielded as fixed-size uint8 batches.

    ``iter_batches`` pads the last batch by repeating its final image and
    returns how many rows are real, so every device call sees one shape.
    A non-square or undersized tile (a WSI border) is centre-padded to its
    square and nearest-resized to ``tile_size``; :attr:`orig_shapes` keeps
    each path's original (h, w) so boxes can be mapped back
    (:func:`~amyloid_yolo_tpu_torch.ops.boxes.rescale_from_tile_frame`).

    ``resize_to`` gathers (nearest, the device's index rule) to the model
    size on the host.  ``fast_decode`` lets the native pool decode at a
    libjpeg DCT scale when ``resize_to`` allows it (1536 → 416 decodes at
    768): the scaled rendition, not bit-identical; opt-in.
    """

    def __init__(self, folder_path: str, tile_size: Optional[int] = None,
                 resize_to: Optional[int] = None, fast_decode: bool = False):
        self.files: List[str] = sorted(glob.glob(os.path.join(folder_path, "*.*")))
        self.tile_size = tile_size
        self.orig_shapes: dict = {}
        self.fast_decode = fast_decode
        self.resize_to = resize_to
        self._ridx = None
        if resize_to is not None and tile_size is not None:
            self._ridx = nearest_indices(resize_to, tile_size)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> Tuple[str, np.ndarray]:
        path = self.files[index % len(self.files)]
        img = load_image_rgb(path)
        self.orig_shapes[path] = img.shape[:2]
        img, _ = pad_to_square_np(img)
        if self.tile_size is not None and img.shape[0] != self.tile_size:
            idx = nearest_indices(self.tile_size, img.shape[0])
            img = np.ascontiguousarray(img[idx][:, idx])
        if self._ridx is not None:
            img = np.ascontiguousarray(img[self._ridx][:, self._ridx])
        return path, img

    def iter_batches(self, batch_size: int, prefetch: int = 2
                     ) -> Iterator[Tuple[List[str], np.ndarray, int]]:
        """Yield (paths, uint8 batch NHWC, n_valid).  Unreadable files are
        skipped with a printed warning."""
        native_pool = self._native_pool()
        if native_pool is not None:
            yield from self._iter_batches_native(native_pool, batch_size, prefetch)
            return

        def load_valid(i: int):
            try:
                return self[i]
            except Exception as e:  # any decode failure: skip the file, keep going
                print(f"Could not read image '{self.files[i % len(self.files)]}': {e}")
                return None

        stop = threading.Event()

        def produce(q: "queue.Queue"):
            try:
                pending = []
                for i in range(len(self.files)):
                    if stop.is_set():
                        break
                    item = load_valid(i)
                    if item is None:
                        continue
                    pending.append(item)
                    if len(pending) == batch_size:
                        q.put(self._pack(pending, batch_size))
                        pending = []
                if pending and not stop.is_set():
                    q.put(self._pack(pending, batch_size))
            except BaseException as e:  # handed to the consumer, which re-raises
                q.put(e)
            q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        yield from _consume_prefetched(q, t, stop)

    def _native_pool(self):
        """The C++ decode pool, when the folder is all JPEG, a tile size is
        declared and the library is built; else ``None``."""
        if self.tile_size is None or not self.files:
            return None
        if not all(f.lower().endswith((".jpg", ".jpeg")) for f in self.files):
            return None
        from .native import TilePool, available

        return TilePool() if available() else None

    def _iter_batches_native(self, pool, batch_size: int, prefetch: int):
        resize = self.resize_to or 0
        denom = 1
        if self.fast_decode and resize and self.tile_size:
            # the largest libjpeg power-of-2 scale whose decode is still at
            # least the gather target (1536 -> 416: denom 2, decode at 768)
            for d in (8, 4, 2):
                if self.tile_size % d == 0 and self.tile_size // d >= resize:
                    denom = d
                    break

        stop = threading.Event()

        def produce(q: "queue.Queue"):
            try:
                start = 0
                while start < len(self.files) and not stop.is_set():
                    chunk = self.files[start:start + batch_size]
                    batch, ok, dims = pool.decode_batch(chunk, self.tile_size, resize,
                                                        scale_denom=denom)
                    good = []
                    for i, p in enumerate(chunk):
                        if not ok[i]:
                            print(f"Could not read image '{p}' (native decoder).")
                            continue
                        h, w = int(dims[i, 0]), int(dims[i, 1])
                        self.orig_shapes[p] = (h, w)
                        if (h, w) != (self.tile_size, self.tile_size):
                            # WSI border tile: the native decoder zero-fills
                            # top-left; the PIL path gives the centred frame
                            good.append(self[start + i])
                        else:
                            good.append((p, batch[i]))
                    start += batch_size
                    if good:
                        q.put(self._pack(good, batch_size))
            except BaseException as e:  # handed to the consumer, which re-raises
                q.put(e)
            q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        try:
            # the inner generator's drain-and-join runs first on close, so the
            # pool is never destroyed while the producer is in decode_batch
            yield from _consume_prefetched(q, t, stop)
        finally:
            pool.close()

    @staticmethod
    def _pack(items, batch_size: int):
        n_valid = len(items)
        while len(items) < batch_size:
            items = items + [items[-1]]
        paths = [p for p, _ in items]
        batch = np.stack([im for _, im in items])
        return paths, batch, n_valid


__all__ = ["ImageFolder", "load_image_rgb", "pad_to_square_np"]
