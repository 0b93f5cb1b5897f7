"""Host datasets: the folder inference stream and the training list.

Counterpart of the reference package's ``io/datasets.py``:
``load_image_rgb``, ``pad_to_square_np``, :class:`ImageFolder`
(``:46-268``) and :class:`ListDataset` (``:271-554``), numpy and PIL code
of which the port keeps its own copy.  Images stay uint8 at tile
resolution on the host; the resize and scale run on the device.  A producer
thread decodes ahead of the consumer.  JPEGs decode through the native
libjpeg reader (:mod:`.native`) where it is built, PIL otherwise: the two
give the same pixels (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import glob
import os
import queue
import random
import threading
import warnings
from typing import Iterator, List, Optional, Sequence, Tuple

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


def _decode_native_or_pil(path: str) -> np.ndarray:
    """HWC uint8 RGB through the native reader for a JPEG when it is built
    (the size read from the header), PIL otherwise or when the reader
    refuses the file (a colour space it does not take)."""
    if path.lower().endswith((".jpg", ".jpeg")) and _HAVE_PIL:
        from . import native

        if native.available():
            with Image.open(path) as im:
                w, h = im.size
            img = native.decode_one(path, h, w)
            if img is not None:
                return img
    return load_image_rgb(path)


class ListDataset:
    """Training dataset over a ``train.txt``-style list with YOLO labels
    (reference ``io/datasets.py:271-554``).

    Label paths come from the image paths (``images`` → ``labels``,
    ``.png``/``.jpg`` → ``.txt``).  Each item is the image centre-padded to
    its square, uint8, with its ``(class, cx, cy, w, h)`` labels
    renormalised to the square; an unreadable image or label file is
    reported and dropped at collate.  All randomness is derived, never
    streamed: the epoch shuffle seeds on ``(seed, epoch)`` and the
    multiscale size is a pure function of the global batch index
    (:meth:`size_for_count`), so an epoch abandoned early
    (``max_batches_per_epoch``) leaves later epochs unchanged.

    ``cache_images`` keeps decoded items in RAM across epochs;
    ``host_resize`` applies the nearest resize to the batch's size on the
    host (the device resize then gathers with identity indices, so the
    samples are bit-identical); ``native_side`` is the collate fallback side
    of a batch that failed to read entirely (:meth:`probe_native_side`).
    """

    def __init__(self, list_path: str, img_size: int = 416, multiscale: bool = True,
                 max_objects: int = 100, augment: bool = True, seed: int = 0,
                 cache_images: bool = False, host_resize: bool = False,
                 native_side: Optional[int] = None):
        with open(list_path, "r") as fh:
            self.img_files = [ln.rstrip() for ln in fh.readlines() if ln.strip()]
        self.label_files = [
            p.replace("images", "labels").replace(".png", ".txt").replace(".jpg", ".txt")
            for p in self.img_files
        ]
        self.img_size = img_size
        self.max_objects = max_objects
        self.multiscale = multiscale
        self.min_size = img_size - 3 * 32
        self.max_size = img_size + 3 * 32
        self.augment = augment
        self.batch_count = 0
        self.seed = seed
        self._base_img_size = img_size
        self._epoch = 0
        self._planned_batches = 0
        self.native_side = native_side
        self._seen_side: Optional[int] = None
        self.cache_images = cache_images
        self._cache: dict = {}
        self.host_resize = host_resize

    def __len__(self) -> int:
        return len(self.img_files)

    def __getitem__(self, index: int):
        """``(path, square uint8 HWC image, (n, 5) normalized labels)``, or
        ``None`` when the image or its labels cannot be read (dropped at
        collate, as ``utils/datasets.py:88-127``).  Failures are never
        cached: a transient error retries next epoch."""
        index = index % len(self.img_files)
        if self.cache_images and index in self._cache:
            return self._cache[index]
        img_path = self.img_files[index]
        try:
            img = _decode_native_or_pil(img_path)
        except Exception:  # any decode failure drops the sample
            print(f"Could not read image '{img_path}'.")
            return None
        label_path = self.label_files[index]
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                boxes = np.loadtxt(label_path).reshape(-1, 5).astype(np.float32)
        except Exception:  # a missing or malformed label file drops the sample
            print(f"Could not read label '{label_path}'.")
            return None
        h, w = img.shape[:2]
        # absolute coords -> pad -> renormalize (transforms.py:56-86 chain)
        boxes = boxes.copy()
        boxes[:, 1] *= w
        boxes[:, 3] *= w
        boxes[:, 2] *= h
        boxes[:, 4] *= h
        img, (pl, pr, pt, pb) = pad_to_square_np(img)
        side = img.shape[0]
        boxes[:, 1] = (boxes[:, 1] + pl) / side
        boxes[:, 2] = (boxes[:, 2] + pt) / side
        boxes[:, 3] = boxes[:, 3] / side
        boxes[:, 4] = boxes[:, 4] / side
        item = (img_path, img, boxes)
        self._seen_side = img.shape[0]
        if self.cache_images:
            self._cache[index] = item
        return item

    def probe_native_side(self) -> Optional[int]:
        """Set :attr:`native_side` from the first readable image header."""
        if self.native_side is None and _HAVE_PIL:
            for p in self.img_files:
                try:
                    with Image.open(p) as im:
                        self.native_side = int(max(im.size))
                    break
                except OSError:
                    continue
        return self.native_side

    def size_for_count(self, count: int) -> int:
        """Multiscale size of global batch ``count`` (1-based, across
        epochs): a new size from ``[img_size − 96, img_size + 96]`` step 32
        every 10th batch, held for the next 10 (``utils/datasets.py:132-133``)."""
        if not self.multiscale or count < 10:
            return self._base_img_size
        rng = random.Random(self.seed * 1_000_003 + 7919 * (count // 10))
        return rng.choice(range(self.min_size, self.max_size + 1, 32))

    def next_size(self) -> int:
        self.batch_count += 1
        self.img_size = self.size_for_count(self.batch_count)
        return self.img_size

    def collate(self, samples: Sequence, row_offset: int = 0, fixed_size: bool = False,
                batch_count: Optional[int] = None) -> Optional[dict]:
        """Stack the readable samples and pad their labels into one
        ``(B·max_objects, 6)`` block of rows ``(batch_idx, class, cx, cy, w,
        h)`` with a validity mask.  ``row_offset`` shifts the batch index;
        ``fixed_size`` keeps failed reads as blank images without labels;
        ``batch_count`` (the global 1-based batch index) fixes the
        multiscale size, else the stateful :meth:`next_size` advances."""
        if fixed_size:
            side = next((s[1].shape[0] for s in samples if s is not None),
                        self.native_side or self._seen_side or self.img_size)
            samples = [s if s is not None else
                       ("<failed>", np.zeros((side, side, 3), np.uint8),
                        np.zeros((0, 5), np.float32))
                       for s in samples]
        else:
            samples = [s for s in samples if s is not None]
        if not samples:
            return None
        if batch_count is not None:
            self.batch_count = batch_count
            self.img_size = img_size = self.size_for_count(batch_count)
        else:
            img_size = self.next_size()
        paths, imgs, boxes_list = zip(*samples)
        batch = np.stack(imgs)
        if self.host_resize and batch.shape[1] != img_size:
            idx = nearest_indices(img_size, batch.shape[1])
            batch = np.ascontiguousarray(batch[:, idx][:, :, idx])
        bsz = len(samples)
        cap = self.max_objects
        targets = np.zeros((bsz * cap, 6), np.float32)
        mask = np.zeros((bsz * cap,), bool)
        for bi, bx in enumerate(boxes_list):
            n = min(len(bx), cap)
            rows = slice(bi * cap, bi * cap + n)
            targets[rows, 0] = row_offset + bi
            targets[rows, 1:] = bx[:n]
            mask[bi * cap:bi * cap + n] = True
        return {"paths": list(paths), "images": batch, "targets": targets,
                "target_mask": mask, "img_size": img_size}

    def iter_epoch(self, batch_size: int, shuffle: bool = True, prefetch: int = 2,
                   shard=None) -> Iterator[dict]:
        """Collated batches of one epoch, decoded ahead by a producer thread.

        ``shard=(process_id, num_processes)``: every process derives the
        same global shuffle and batches and collates only its contiguous row
        block, with ragged tails dropped and failed reads blanked, so all
        yield the same batch count and shapes.  Multiscale counts go by
        planned batch position and the epoch's count is reserved up front.
        """
        self._epoch += 1
        order = list(range(len(self)))
        if shuffle:
            random.Random(self.seed * 2_654_435_761
                          + 1_442_695_041 * self._epoch).shuffle(order)
        pid, nproc = shard if shard is not None else (0, 1)
        if shard is not None:
            if batch_size % nproc:
                raise ValueError(f"global batch {batch_size} must divide over {nproc} hosts")
            order = order[: len(order) - (len(order) % batch_size)]
        local_b = batch_size // nproc
        count_base = self._planned_batches
        self._planned_batches += (len(order) + batch_size - 1) // batch_size

        stop = threading.Event()

        def produce(q: "queue.Queue"):
            try:
                for j, start in enumerate(range(0, len(order), batch_size)):
                    if stop.is_set():
                        break
                    idxs = order[start:start + batch_size]
                    if shard is None:
                        batch = self.collate([self[i] for i in idxs],
                                             batch_count=count_base + j + 1)
                    else:
                        mine = idxs[pid * local_b:(pid + 1) * local_b]
                        batch = self.collate([self[i] for i in mine], row_offset=pid * local_b,
                                             fixed_size=True, batch_count=count_base + j + 1)
                    if batch is not None:
                        q.put(batch)
            except BaseException as e:  # handed to the consumer, which re-raises
                q.put(e)
            q.put(None)

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        t = threading.Thread(target=produce, args=(q,), daemon=True)
        t.start()
        yield from _consume_prefetched(q, t, stop)


__all__ = ["ImageFolder", "ListDataset", "load_image_rgb", "pad_to_square_np"]
