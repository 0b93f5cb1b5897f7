"""The whole-slide sweep, the CERAD correlation and the speed check.

Counterpart of the reference package's ``analysis/validation.py``, after
the original ``validation.py``:

* :func:`get_stain` and :func:`calculate_plaque_counts_per_wsi` (its
  ``:43-192``, the original
  ``:30-175``): the detector over every 1536² tile of every WSI, the
  per-tile rescale, union merge and CAA filter, optionally the cross-tile
  merge, and the two count pickles in the original's dict shapes;
* :func:`plot_cerad_vs_counts` (its ``:195``, the original ``:177-215``):
  boxplots of the model's counts per CERAD category;
* :func:`plot_cerad_statistical_significance` (its ``:254``, the original
  ``:217-262``): pairwise t-tests, Cohen's d and a power heatmap, the power
  from statsmodels where it is installed, else a normal approximation;
* :func:`speed_check` (its ``:306``, the original ``:282-366``): model time
  against down time, per WSI and per tile, into a pickle;
* :func:`calculate_avg_speed_of_tang_sliding_window` (its ``:391``, the
  original ``:368-401``): the prior art's seconds per WSI from its
  published logs.

pandas, matplotlib and scipy are imported inside the functions that use
them.
"""

from __future__ import annotations

import os
import pickle
import random
import socket
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..detectors import Detector
from ..domain import CAAFilter, draw_detections
from ..io.datasets import ImageFolder, load_image_rgb
from ..io.tiles import iter_wsi_tile_dirs, tile_origin
from ..io.tissue import prefilter_tile_paths
from ..ops.merge import merge_detections, merge_wsi_detections


def get_stain(string: str) -> str:
    """Parity ``validation.py:264-280``."""
    if "4G8" in string:
        return "4G8"
    if "Abeta42" in string:
        return "ABeta42"
    if "Abeta40" in string:
        return "ABeta40"
    if "beta_amyloid" in string:
        return "6E10"
    raise Exception(f"cannot determine stain from string: {string}")


def calculate_plaque_counts_per_wsi(
    directory: str,
    detector: Detector,
    caa_filter: Optional[CAAFilter] = None,
    prefix: str = "CERAD_",
    pickles_dir: str = "pickles",
    batch_size: int = 8,
    classes: Sequence[str] = ("CAA", "Cored"),
    save_images: bool = False,
    output_dir: str = "output",
    wsi_whitelist: Optional[Sequence[str]] = None,
    cross_tile_merge: bool = False,
    background_skip: bool = False,
    background_max_bpp: Optional[float] = None,
    background_min_tissue: Optional[float] = None,
) -> Dict[str, Dict[str, int]]:
    """Sweep every tile of every WSI under ``directory``.

    ``background_skip=True`` runs the sweep-time background prefilter
    (:func:`~amyloid_yolo_tpu_torch.io.tissue.prefilter_tile_paths`: a free
    file-size stage, then a cheap decode-confirm stage) before any tile is
    decoded at full size: the host decode is the sweep's bottleneck and
    real WSIs are mostly background.  Skipped tiles still get zero-count
    entries in the per-tile dictionary (the reference records every tile).
    Default off, as in the reference package.

    Saves ``<prefix>WSI_plaque_counts_dictionary.pkl`` and
    ``<prefix>1536_plaque_counts_dictionary.pkl`` with the reference's
    exact dict shapes (``validation.py:71-76,173-174``).

    ``cross_tile_merge=True`` additionally merges detections ACROSS
    adjacent tile boundaries (new capability — the reference merges only
    within a tile, ``validation.py:127-129``, double-counting plaques that
    straddle a boundary).  Per-tile merge + CAA filter run first with exact
    reference semantics; then :func:`~amyloid_yolo_tpu_torch.ops.merge.
    merge_wsi_detections` unifies straddlers in slide space, and each
    merged box counts once, toward the tile containing its center.

    Each row directory goes through :meth:`~amyloid_yolo_tpu_torch.detectors.
    Detector.detect_dataset`: the per-tile rescale, merge and CAA filter of
    ``detect_folder``, with its device pipeline and its int8 calibration;
    the sweep only prefilters, counts and merges across tiles.
    """
    os.makedirs(pickles_dir, exist_ok=True)
    wsi_names = sorted(os.listdir(directory))
    wsi_counts: Dict[str, Dict[str, int]] = {w: {"Cored": 0, "CAA": 0} for w in wsi_names}
    tile_counts: Dict[str, Dict[str, Dict[str, int]]] = {w: {} for w in wsi_names}

    def save_tile_render(path, dets):
        os.makedirs(output_dir, exist_ok=True)
        img = load_image_rgb(path)
        out = draw_detections(img, dets, classes)
        from PIL import Image

        out_name = path.replace("/", "_").replace(".jpg", "") + ".png"
        Image.fromarray(out).save(os.path.join(output_dir, out_name))

    # group row-subdirectories by WSI so cross-tile merging sees every
    # tile of a slide at once
    dirs_by_wsi: Dict[str, List[str]] = {}
    for wsi, tile_dir in iter_wsi_tile_dirs(directory):
        dirs_by_wsi.setdefault(wsi, []).append(tile_dir)

    for wsi, tile_dirs in dirs_by_wsi.items():
        if wsi_whitelist is not None and wsi not in wsi_whitelist:
            continue
        dets_by_path: Dict[str, Optional[np.ndarray]] = {}
        n_skipped = 0
        n_total = 0
        for tile_dir in tile_dirs:
            folder = ImageFolder(
                tile_dir, tile_size=detector.tile_size,
                resize_to=detector.model_size if detector.host_resize else None)
            n_total += len(folder.files)
            if background_skip:
                kw = {}
                if background_max_bpp is not None:
                    kw["max_bpp"] = background_max_bpp
                if background_min_tissue is not None:
                    kw["min_tissue"] = background_min_tissue
                folder.files, skipped = prefilter_tile_paths(folder.files, **kw)
                n_skipped += len(skipped)
                for p in skipped:  # reference records every tile: 0 counts
                    tile_counts[wsi].setdefault(p, {"Cored": 0, "CAA": 0})
            if not folder.files:
                continue
            found = detector.detect_dataset(
                folder, batch_size, merge_boxes=True,
                caa_filter=caa_filter.filter_path if caa_filter is not None else None)
            for path, dets in found.items():
                tile_counts[wsi].setdefault(path, {"Cored": 0, "CAA": 0})
                if dets is None or len(dets) == 0:
                    continue
                dets_by_path[path] = dets
                if save_images:
                    save_tile_render(path, dets)

        if background_skip and n_total:
            print(f"{wsi}: background prefilter skipped {n_skipped}/{n_total} "
                  f"tiles ({100.0 * n_skipped / n_total:.1f}%)", flush=True)

        if cross_tile_merge:
            origins = {p: tile_origin(p, detector.tile_size)
                       for p in dets_by_path}
            rows, owners = merge_wsi_detections(
                dets_by_path, origins, tile_size=detector.tile_size)
            for row, owner in zip(rows, owners):
                name = classes[int(row[6])]
                wsi_counts[wsi][name] += 1
                tile_counts[wsi][owner][name] += 1
        else:
            for path, dets in dets_by_path.items():
                for row in dets:
                    name = classes[int(row[6])]
                    wsi_counts[wsi][name] += 1
                    tile_counts[wsi][path][name] += 1

    if getattr(detector, "overflow_images", 0):
        import warnings

        warnings.warn(
            f"WSI sweep: {detector.overflow_images}/{detector.images_seen} "
            f"tiles exceeded the NMS candidate pool "
            f"(nms_pool={detector.nms_pool}, max seen "
            f"{detector.max_candidates_seen}) — detections were truncated "
            f"on those tiles; rebuild the Detector with a larger nms_pool/"
            f"capacity for uncapped-reference parity.", UserWarning,
            stacklevel=2)
    with open(os.path.join(pickles_dir, prefix + "WSI_plaque_counts_dictionary.pkl"), "wb") as fh:
        pickle.dump(wsi_counts, fh)
    with open(os.path.join(pickles_dir, prefix + "1536_plaque_counts_dictionary.pkl"), "wb") as fh:
        pickle.dump(tile_counts, fh)
    return wsi_counts


def plot_cerad_vs_counts(
    counts_pickle: str, cerad_csv: str, plaque_type: str = "Cored",
    cerad_type: str = "CERAD", figures_dir: str = "figures",
) -> Dict:
    """Boxplots of the counts per CERAD category into
    ``CERAD_correlation_<plaque_type>_<cerad_type>.png``
    (``validation.py:177-215``); returns ``{category: [counts]}``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    fig, ax = plt.subplots()
    if cerad_type == "CERAD":
        categories: List = ["none", "sparse", "moderate", "frequent"]
        column_key = "CERAD"
        ax.set_xlabel("CERAD-like Score", fontsize=12)
    else:
        categories = list(range(0, 4))
        column_key = cerad_type
        ax.set_xlabel(cerad_type, fontsize=12)
    with open(counts_pickle, "rb") as fh:
        wsi_counts = pickle.load(fh)
    scores = pd.read_csv(cerad_csv)
    cmap: Dict = {cat: [] for cat in categories}
    for _, row in scores.iterrows():
        wsi = row["WSI_ID"]
        if wsi not in wsi_counts:
            continue
        cmap[row[column_key]].append(wsi_counts[wsi][plaque_type])
    ax.boxplot([cmap[c] for c in categories])
    for i, cat in enumerate(categories):
        xs = [i + 1 + random.uniform(-0.02, 0.02) for _ in cmap[cat]]
        ax.scatter(xs, cmap[cat], s=6, color="blue")
    ax.set_ylabel(f"{plaque_type} Count According to Model", fontsize=12)
    ax.set_xticklabels([f"{c}\nn={len(cmap[c])} WSIs" for c in categories], fontsize=10)
    plt.title("Model Correlation with CERAD-like Score")
    os.makedirs(figures_dir, exist_ok=True)
    plt.savefig(os.path.join(figures_dir, f"CERAD_correlation_{plaque_type}_{cerad_type}.png"),
                dpi=300)
    plt.close("all")
    return cmap


def _ttest_power(effect_size: float, nobs: int, alpha: float = 0.05) -> float:
    """Two-sided two-sample t-test power: statsmodels' ``ttest_power``
    where it is installed (the original ``validation.py:238``), else the
    normal approximation."""
    try:
        import statsmodels.stats.power as smp  # type: ignore

        return float(smp.ttest_power(effect_size, nobs=nobs, alpha=alpha,
                                     alternative="two-sided"))
    except Exception:
        from scipy.stats import norm

        z_a = norm.ppf(1 - alpha / 2)
        z = effect_size * np.sqrt(nobs) / 2 - z_a
        return float(norm.cdf(z))


def plot_cerad_statistical_significance(
    counts_pickle: str, cerad_csv: str, plaque_type: str = "Cored",
    figures_dir: str = "figures",
) -> Dict:
    """Pairwise t-tests between the CERAD categories, with Cohen's d and
    the power, and a heatmap of the p-values into
    ``CERAD-t-test-p-values.png`` (``validation.py:217-262``); returns
    ``{(c1, c2): (t, p, power)}``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd
    from scipy.stats import ttest_ind

    with open(counts_pickle, "rb") as fh:
        wsi_counts = pickle.load(fh)
    scores = pd.read_csv(cerad_csv)
    categories = ["none", "sparse", "moderate", "frequent"]
    cmap: Dict = {c: [] for c in categories}
    for _, row in scores.iterrows():
        if row["WSI_ID"] in wsi_counts:
            cmap[row["CERAD"]].append(wsi_counts[row["WSI_ID"]][plaque_type])
    t_test_map = {}
    grid = []
    for c1 in categories:
        line = []
        for c2 in categories:
            t, p = ttest_ind(cmap[c1], cmap[c2])
            pooled = np.sqrt((np.std(cmap[c1]) ** 2 + np.std(cmap[c2]) ** 2) / 2.0)
            effect = (np.mean(cmap[c1]) - np.mean(cmap[c2])) / pooled if pooled else 0.0
            power = _ttest_power(effect, nobs=len(cmap[c1]) + len(cmap[c2]))
            t_test_map[(c1, c2)] = (float(t), float(p), float(power))
            line.append(float(p))
        grid.append(line)
    grid_arr = np.asarray(grid)
    fig, ax = plt.subplots()
    im = ax.imshow(grid_arr, vmin=0, vmax=0.30, cmap="coolwarm")
    ax.set_xticks(range(len(categories)))
    ax.set_yticks(range(len(categories)))
    ax.set_xticklabels(categories, fontsize=11)
    ax.set_yticklabels(categories, fontsize=11)
    for i in range(len(categories)):
        for j in range(len(categories)):
            v = grid_arr[i][j]
            txt = f"{v:.2e}" if v < 0.001 else str(round(v, 3))
            ax.text(j, i, txt, ha="center", va="center", color="white", fontsize=11)
    fig.colorbar(im, ax=ax)
    ax.set_title("t-test p-values", fontsize=12)
    fig.tight_layout()
    os.makedirs(figures_dir, exist_ok=True)
    plt.savefig(os.path.join(figures_dir, "CERAD-t-test-p-values.png"), dpi=300)
    plt.close("all")
    return t_test_map


def speed_check(
    directory: str,
    detector: Detector,
    caa_filter: Optional[CAAFilter] = None,
    include_merge_and_filter: bool = True,
    batch_sizes: Sequence[int] = (1,),
    pickles_dir: str = "pickles",
    tag: Optional[str] = None,
) -> Dict:
    """Wall-clock sweep of every tile under ``directory``: model time against
    down time, the average per WSI and per tile, for each batch size
    (``speedCheck``, ``validation.py:282-366``).

    Down time counts building each row's dataset AND every wait for the
    next batch from the decode prefetcher, as the original isolates its
    DataLoader stalls (``validation.py:300-340``): decoding overlaps the
    device, so a small down time means the prefetcher kept up.  Before the
    clock stops, each of the ``Detector``'s cards (one, or its mesh's) is
    synchronized.

    Saves ``run_times_<tag>_merge_and_filter_<bool>_<host>.pkl``; ``tag``
    defaults to the platform of the ``Detector``'s device: ``gpu`` for a
    card, else the device type (the reference package's default is
    ``tpu``).
    """
    hostname = socket.gethostname()
    devices = list(detector.mesh.devices) if detector.mesh is not None else [detector.device]
    if tag is None:
        tag = "gpu" if detector.device.type == "cuda" else detector.device.type
    wsi_dirs = iter_wsi_tile_dirs(directory)
    n_wsi = len({w for w, _ in wsi_dirs})
    time_dict = {bs: {} for bs in batch_sizes}
    for bs in batch_sizes:
        num_tiles = 0
        down_time = 0.0
        t0 = time.time()
        for wsi, tile_dir in wsi_dirs:
            t1 = time.time()
            folder = ImageFolder(
                tile_dir, tile_size=detector.tile_size,
                resize_to=detector.model_size if detector.host_resize else None)
            it = folder.iter_batches(bs)
            down_time += time.time() - t1
            while True:
                t1 = time.time()
                item = next(it, None)
                down_time += time.time() - t1   # blocked on the host decode
                if item is None:
                    break
                paths, batch, n_valid = item
                ragged = detector.detect_batch_ragged(batch, n_valid=n_valid)
                if include_merge_and_filter:
                    for path, dets in list(zip(paths, ragged))[:n_valid]:
                        if dets is None:
                            continue
                        dets = merge_detections(dets)
                        if caa_filter is not None:
                            dets = caa_filter.filter_path(path, dets)
                num_tiles += n_valid
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        final = time.time()
        model_time = final - t0 - down_time
        time_dict[bs] = {
            "machine": hostname,
            "time spent": final,
            "down time": down_time,
            "model time spent": model_time,
            "avg time / WSI": model_time / float(max(n_wsi, 1)),
            "avg time / 1536 img": model_time / float(max(num_tiles, 1)),
            "num 1536 images": num_tiles,
        }
    os.makedirs(pickles_dir, exist_ok=True)
    with open(os.path.join(
            pickles_dir,
            f"run_times_{tag}_merge_and_filter_{include_merge_and_filter}_{hostname}.pkl"),
            "wb") as fh:
        pickle.dump(time_dict, fh)
    return time_dict


TANG_TQDM_LOGS = [
    "28/28 [2:24:17<00:00, 309.19s/it]", "49/49 [8:55:56<00:00, 656.25s/it]",
    "28/28 [2:40:59<00:00, 345.00s/it]", "28/28 [2:45:04<00:00, 353.73s/it]",
    "28/28 [2:45:54<00:00, 355.52s/it]", "28/28 [2:33:49<00:00, 329.63s/it]",
    "27/27 [2:35:41<00:00, 345.99s/it]", "26/26 [3:13:59<00:00, 447.68s/it]",
    "28/28 [3:08:24<00:00, 403.74s/it]", "21/21 [2:04:40<00:00, 356.22s/it]",
    "25/25 [2:35:53<00:00, 374.13s/it]", "27/27 [2:26:48<00:00, 326.22s/it]",
    "31/31 [3:14:01<00:00, 375.53s/it]", "28/28 [3:23:10<00:00, 435.36s/it]",
    "26/26 [2:35:15<00:00, 358.28s/it]", "28/28 [2:47:33<00:00, 359.04s/it]",
    "28/28 [2:43:00<00:00, 349.29s/it]", "31/31 [3:25:29<00:00, 397.72s/it]",
    "25/25 [2:08:55<00:00, 309.42s/it]", "28/28 [2:56:10<00:00, 377.54s/it]",
]


def calculate_avg_speed_of_tang_sliding_window() -> float:
    """Seconds per WSI of the prior art's sliding window, from its
    published tqdm logs (``validation.py:368-401``).

    Each log line is one run over N WSIs at ``X s/it``, one iteration a
    WSI; the figure is the mean of the s/it values.  The original averages
    each line's total time instead, the mean length of a *run*; this is the
    per-WSI figure, as in the reference package.
    """
    rates = []
    for log in TANG_TQDM_LOGS:
        rate = log[log.find(", ") + 2:log.find("s/it")]
        rates.append(float(rate))
    return float(np.mean(rates))


__all__ = [
    "calculate_plaque_counts_per_wsi", "plot_cerad_vs_counts",
    "plot_cerad_statistical_significance", "speed_check", "get_stain",
    "calculate_avg_speed_of_tang_sliding_window",
]
