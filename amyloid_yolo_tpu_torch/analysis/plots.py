"""The study's figures: PRC curves, AP against IoU, interrater heatmaps.

Counterpart of the reference package's ``analysis/plots.py``, the
matplotlib layer of the original ``prospective.py``: every figure of the
study, drawn from the artifacts :mod:`.prospective` writes.  Host code;
matplotlib is imported inside the functions, with the Agg backend.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..io.datasets import load_image_rgb
from .prospective import (
    AMYLOID_CLASSES, ANNOTATION_TIME_HOURS, ap_map_from_tables,
    average_precision_from_table,
)

ANNOTATOR_COLORS = {
    "NP1": "#ff8800", "NP2": "#03ebfc", "NP3": "#fc039d", "NP4": "#23ba28",
    "merged": "#51169e", "consensus": "#000000",
}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_prc(prc_dir: str, annotator: str, val_type: str = "prospective",
             figures_dir: str = "figures", separate_legend: bool = True,
             iou_thresholds: Sequence[float] = (0.2, 0.4, 0.6, 0.8)) -> None:
    """PRC curves at several IoU thresholds (``plotPRC``,
    ``prospective.py:480-520``)."""
    import pandas as pd

    plt = _plt()
    os.makedirs(figures_dir, exist_ok=True)
    for amyloid_class in AMYLOID_CLASSES:
        fig, ax = plt.subplots()
        lines, labels = [], []
        for t in iou_thresholds:
            df = pd.read_csv(os.path.join(
                prc_dir, f"{val_type}_PRC_table_{annotator}_iou_{round(t, 1)}_{amyloid_class}.csv"))
            y = np.asarray(df["TP"], float)
            s = np.asarray(df["Conf"], float)
            order = np.argsort(-s, kind="mergesort")
            tp = np.cumsum(y[order])
            precision = tp / (np.arange(len(y)) + 1)
            recall = tp / max(y.sum(), 1e-16)
            ap = average_precision_from_table(df)
            line, = ax.plot(recall, precision, label=f"AP@{t} = {round(ap, 2)}")
            lines.append(line)
            labels.append(f"AP@{t} = {round(ap, 3)}")
        ax.set_xlabel("Recall", fontsize=12)
        ax.set_ylabel("Precision", fontsize=12)
        plt.xlim([0.0, 1.0])
        plt.ylim([0.0, 1.0])
        plt.title(f"{amyloid_class} PRC, {annotator}")
        if separate_legend:
            fig.savefig(os.path.join(figures_dir, f"PRC_plot_{annotator}_{amyloid_class}.png"))
            legend_fig = plt.figure("legend")
            legend_fig.legend(lines, labels, fontsize=10, loc="center")
            legend_fig.savefig(os.path.join(
                figures_dir, f"PRC_plot_{annotator}_{amyloid_class}_legend.png"))
            legend_fig.clf()
        else:
            ax.legend(loc="upper right", fontsize=10)
            fig.savefig(os.path.join(figures_dir, f"PRC_plot_{annotator}_{amyloid_class}.png"))
        plt.close("all")


def plot_aps_for_prospective(prc_dir: str, figures_dir: str = "figures",
                             annotators: Optional[Sequence[str]] = None,
                             overlay_summary: Optional[Dict] = None,
                             ap_map_pickle: Optional[str] = None) -> Dict:
    """AP vs IoU per annotator (``plotAPsForProspective``,
    ``prospective.py:285-328``); returns and optionally pickles the AP map."""
    plt = _plt()
    if annotators is None:
        annotators = ["consensus"] + [f"NP{i}" for i in range(1, 5)]
    iou_thresholds = list(np.arange(0.1, 1.0, 0.1))
    ap_map = ap_map_from_tables(prc_dir, annotators, "prospective", iou_thresholds)
    if ap_map_pickle:
        with open(ap_map_pickle, "wb") as fh:
            pickle.dump(ap_map, fh)
    os.makedirs(figures_dir, exist_ok=True)
    for amyloid_class in AMYLOID_CLASSES:
        fig, ax = plt.subplots()
        for annotator in annotators:
            ys = [ap_map[annotator][amyloid_class][t] for t in iou_thresholds]
            ax.plot(iou_thresholds, ys, linestyle="-", marker="o",
                    label=annotator, color=ANNOTATOR_COLORS.get(annotator))
        plt.ylim([0.0, 1.0])
        plt.title(f"{amyloid_class} Average Precisions\nper Annotator")
        ax.set_xlabel("IOU Threshold", fontsize=12)
        ax.set_ylabel("Average Precision", fontsize=12)
        if overlay_summary is not None:
            s = overlay_summary[amyloid_class]
            x, avg, std = np.asarray(s["x"]), np.asarray(s["avg"]), np.asarray(s["std"])
            plt.plot(x, avg, linestyle="--", marker=".")
            plt.fill_between(x, avg - std, avg + std, alpha=0.5)
        ax.legend(loc="upper right", fontsize=10)
        plt.savefig(os.path.join(figures_dir, f"PRC_cumulative_plot_{amyloid_class}.png"),
                    dpi=300)
        plt.close("all")
    return ap_map


def plot_aps_for_phases(prc_dir: str, figures_dir: str = "figures") -> Dict:
    """Model v1 vs v2 AP-vs-IoU (``plotAPsForPhases``,
    ``prospective.py:251-283``)."""
    plt = _plt()
    iou_thresholds = list(np.arange(0.1, 1.0, 0.1))
    phases = ["phase1", "phase2"]
    ap_map: Dict = {}
    for phase in phases:
        ap_map[phase] = ap_map_from_tables(
            prc_dir, [phase], phase, iou_thresholds)[phase]
    os.makedirs(figures_dir, exist_ok=True)
    for phase in phases:
        fig, ax = plt.subplots()
        for amyloid_class in AMYLOID_CLASSES:
            ys = [ap_map[phase][amyloid_class][t] for t in iou_thresholds]
            ax.plot(iou_thresholds, ys, linestyle="-", marker="o", label=amyloid_class)
        plt.ylim([0.0, 1.0])
        modelv = "One" if phase == "phase1" else "Two"
        plt.title(f"Model Version {modelv} Average Precisions")
        ax.set_xlabel("IOU Threshold", fontsize=12)
        ax.set_ylabel("Average Precision", fontsize=12)
        ax.legend(loc="upper right", fontsize=10)
        plt.savefig(os.path.join(figures_dir, f"PRC_cumulative_plot_{phase}.png"), dpi=300)
        plt.close("all")
    return ap_map


def plot_interrater_agreement(pair_map: Dict, figures_dir: str = "figures",
                              iou_threshold: float = 0.5,
                              annotators: Optional[Sequence[str]] = None) -> None:
    """Heatmap of pairwise agreement (``plotInterraterAgreement``,
    ``prospective.py:443-478``)."""
    plt = _plt()
    if annotators is None:
        annotators = [f"NP{i}" for i in range(1, 5)]
    os.makedirs(figures_dir, exist_ok=True)
    for amyloid_class in AMYLOID_CLASSES:
        grid = []
        for a1 in annotators:
            row = []
            for a2 in annotators:
                if a1 == a2:
                    row.append(1.0)
                elif (a1, a2) in pair_map:
                    row.append(pair_map[(a1, a2)][amyloid_class])
                else:
                    row.append(pair_map[(a2, a1)][amyloid_class])
            grid.append(row)
        fig, ax = plt.subplots()
        im = ax.imshow(grid, vmin=0, vmax=1)
        ax.set_xticks(range(len(annotators)))
        ax.set_yticks(range(len(annotators)))
        ax.set_xticklabels(annotators, fontsize=11)
        ax.set_yticklabels(annotators, fontsize=11)
        for i in range(len(annotators)):
            for j in range(len(annotators)):
                ax.text(j, i, str(round(grid[i][j], 2)), ha="center",
                        va="center", color="black", fontsize=11)
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        ax.set_title(f"{amyloid_class} Interrater Agreement Accuracy, "
                     f"IOU = {round(iou_threshold, 2)}", fontsize=12)
        plt.savefig(os.path.join(
            figures_dir,
            f"interrater_agreement_accuracy_{amyloid_class}_{round(iou_threshold, 2)}.png"),
            dpi=300)
        plt.close("all")


def plot_precisions_relative_to_each_other(
    precision_dict: Dict, figures_dir: str = "figures",
    plot_type: str = "aggregate",
) -> Dict:
    """Merry-go-round precision plots + global summary
    (``plotPrecisionsOfAnnotatorsRelativeToEachOther``,
    ``prospective.py:565-629``); returns the summary dict used as the
    overlay in :func:`plot_aps_for_prospective`."""
    plt = _plt()
    os.makedirs(figures_dir, exist_ok=True)
    results: Dict = {}
    for amyloid_class in AMYLOID_CLASSES:
        global_ys = []
        x = None
        for ground_truth, inner in precision_dict[amyloid_class].items():
            fig, ax = plt.subplots()
            ys = []
            for annotator2, curve in inner.items():
                x = sorted(curve.keys())
                y = [curve[t] for t in x]
                ys.append(y)
                global_ys.append(y)
                if plot_type == "individual":
                    plt.plot(x, y, linestyle="-", marker="o", label=annotator2,
                             color=ANNOTATOR_COLORS.get(annotator2))
            if plot_type == "aggregate" and ys:
                arr = np.array(ys)
                avg, std = arr.mean(axis=0), arr.std(axis=0)
                plt.plot(x, avg)
                plt.fill_between(x, avg - std, avg + std, alpha=0.5)
            plt.ylim([0.0, 1.0])
            plt.title(f"Amyloid Class = {amyloid_class}\nGround truth = {ground_truth}")
            ax.set_xlabel("IOU Threshold", fontsize=12)
            ax.set_ylabel("Precision", fontsize=12)
            if plot_type == "individual":
                ax.legend(loc="upper right", fontsize=10)
            plt.savefig(os.path.join(
                figures_dir,
                f"annotator_precisions_relative_to_each_other_{amyloid_class}_{ground_truth}.png"),
                dpi=300)
            plt.close("all")
        arr = np.array(global_ys)
        avg, std = arr.mean(axis=0), arr.std(axis=0)
        fig, ax = plt.subplots()
        plt.plot(x, avg, linestyle="-", marker="o")
        plt.fill_between(x, avg - std, avg + std, alpha=0.5)
        plt.title(f"Comparing Annotators to Each Other\nAmyloid Class = {amyloid_class}")
        ax.set_xlabel("IOU Threshold", fontsize=12)
        ax.set_ylabel("Precision", fontsize=12)
        plt.savefig(os.path.join(
            figures_dir,
            f"annotator_precisions_relative_to_each_other_{amyloid_class}_global.png"),
            dpi=300)
        plt.close("all")
        results[amyloid_class] = {"x": list(x), "avg": avg, "std": std}
    return results


def plot_time_chart(ap_map: Dict, figures_dir: str = "figures",
                    iou_threshold: float = 0.5) -> None:
    """Annotation hours vs AP scatter (``plotTimeChart``,
    ``prospective.py:631-660``)."""
    plt = _plt()
    os.makedirs(figures_dir, exist_ok=True)
    fig, ax = plt.subplots()
    annotators = [f"NP{i}" for i in range(1, 5)]
    for amyloid_class in AMYLOID_CLASSES:
        marker = "$*$" if amyloid_class == "Cored" else "$@$"
        for annotator in annotators:
            x = ANNOTATION_TIME_HOURS[annotator]
            y = ap_map[annotator][amyloid_class][iou_threshold]
            kwargs = dict(s=120, marker=marker, color=ANNOTATOR_COLORS[annotator])
            if amyloid_class == "Cored":
                ax.scatter(x, y, label=annotator, **kwargs)
            else:
                ax.scatter(x, y, **kwargs)
    plt.title("Time Spent Annotating\nVersus AP")
    plt.ylim([0.0, 1.0])
    ax.set_xlabel("Annotation Hours", fontsize=12)
    ax.set_ylabel(f"Average Precision @IOU={iou_threshold}", fontsize=12)
    ax.legend(loc="upper right", fontsize=10)
    plt.savefig(os.path.join(figures_dir, "time_vs_AP.png"), dpi=300)
    plt.close("all")


def plot_all_annotations(annotations_by_np: Dict, image_folder: str,
                         output_dir: str = "output/AllAnnotations") -> None:
    """Overlay every annotator's boxes per image (``plotAllAnnotations``,
    ``prospective.py:662-690``), drawn with PIL."""
    from PIL import Image, ImageDraw

    os.makedirs(output_dir, exist_ok=True)
    symbols = {"Cored": "*", "CAA": "@"}
    rgb = {k: tuple(int(v[i:i + 2], 16) for i in (1, 3, 5))
           for k, v in ANNOTATOR_COLORS.items() if k.startswith("NP")}
    first = next(iter(annotations_by_np.values()))
    for img_name in first.keys():
        img = Image.fromarray(load_image_rgb(os.path.join(image_folder, img_name)))
        d = ImageDraw.Draw(img)
        for annotator, annotations in annotations_by_np.items():
            for entry in annotations.get(img_name, []):
                coord, cls = entry[0], entry[1]
                color = rgb.get(annotator, (0, 0, 0))
                d.rectangle([coord["x1"], coord["y1"], coord["x2"], coord["y2"]],
                            outline=color, width=3)
                d.text((coord["x1"], max(0, coord["y1"] - 14)),
                       symbols.get(cls, "?"), fill=color)
        img.save(os.path.join(output_dir, img_name))


def plot_image_comparisons(annotations: Dict, predictions: Dict,
                           image_folder: str, output_dir: str,
                           overlay_labels: bool = True,
                           overlay_predictions: bool = True,
                           val_type: str = "prospective") -> None:
    """Prediction vs annotation overlays (``plotImageComparisons``,
    ``prospective.py:692-749``): predictions colored by class, labels black."""
    from PIL import Image, ImageDraw

    os.makedirs(output_dir, exist_ok=True)
    symbols = {"Cored": "*", "CAA": "@"}
    for img_name in annotations:
        img = Image.fromarray(load_image_rgb(os.path.join(image_folder, img_name)))
        d = ImageDraw.Draw(img)
        if overlay_predictions:
            for entry in predictions.get(img_name, []):
                coord, cls = entry[0], entry[1]
                color = (0, 0, 255) if cls == "CAA" else (255, 0, 0)
                d.rectangle([coord["x1"], coord["y1"], coord["x2"], coord["y2"]],
                            outline=color, width=3)
        if overlay_labels:
            for entry in annotations[img_name]:
                coord, cls = entry[0], entry[1]
                d.rectangle([coord["x1"], coord["y1"], coord["x2"], coord["y2"]],
                            outline=(0, 0, 0), width=3)
                d.text((coord["x1"], max(0, coord["y1"] - 14)),
                       symbols.get(cls, "?"), fill=(0, 0, 0))
        img.save(os.path.join(output_dir, f"{val_type}_{img_name}"))


__all__ = [
    "plot_prc", "plot_aps_for_prospective", "plot_aps_for_phases",
    "plot_interrater_agreement", "plot_precisions_relative_to_each_other",
    "plot_time_chart", "plot_all_annotations", "plot_image_comparisons",
    "ANNOTATOR_COLORS",
]
