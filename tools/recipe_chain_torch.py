"""Two-phase training-recipe runner of the PyTorch port: the reference's
published protocol as ONE reproducible command (``tools/recipe_chain.py``'s
counterpart).

The reference trains YOLOv3 in two stages (its ``train.py`` driven by
hand: a high-lr run from scratch, then a lower-lr run resumed params-only
from the best checkpoint — its ``--pretrained_weights`` semantics):

    python tools/recipe_chain_torch.py --tag myrun \
        [--data_config /tmp/prospective_data/custom.data] \
        [--batch_size 8 --gradient_accumulations 2] [--img_size 416] \
        [--lr1 1e-3 --lr2 3e-4] [--epochs1 80 --epochs2 50] \
        [--ema_decay 0.999] [--device cuda] [--dry_run]

Each phase is a SEPARATE OS process (``python -m amyloid_yolo_tpu_torch.cli
train ... --device <device>``), so a phase crash cannot corrupt the other
phase's state.  The best epoch is read from the phase's JSONL event log
(``validation/mAP``; with ``--ema_decay`` the raw-vs-EMA winner is chosen,
and the ``#ema`` suffix of ``io/weights.py:load_pretrained`` selects the
EMA parameters of the checkpoint ``yolov3_ckpt_<epoch>.pt`` when the EMA
arm wins).  ``--study`` (the study-protocol parity overlay,
``tools/run_ckpt_parity_study.py``) raises: it reads the 200 real
prospective images and the annotators' pickles, which are not in the
repository.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def best_of(events_path: str, metric: str):
    """(best value, epoch) of ``metric`` in a trainer events.jsonl."""
    best = (-1.0, -1)
    with open(events_path) as fh:
        for line in fh:
            d = json.loads(line)
            if metric in d and d[metric] > best[0]:
                best = (d[metric], d["step"])
    return best


def latest_events(logdir: str):
    paths = sorted(glob.glob(os.path.join(logdir, "*", "events.jsonl")),
                   key=os.path.getmtime)
    return paths[-1] if paths else None


def pick_winner(events_path: str, ckpt_dir: str, ema: bool):
    """Best checkpoint path of a phase: raw vs (optional) EMA arm, with
    the '#ema' suffix every weights surface accepts when EMA wins."""
    raw_v, raw_e = best_of(events_path, "validation/mAP")
    pick, arm = os.path.join(ckpt_dir, f"yolov3_ckpt_{raw_e}.pt"), "raw"
    if ema:
        ema_v, ema_e = best_of(events_path, "validation/mAP_ema")
        if ema_v > raw_v:
            pick = os.path.join(ckpt_dir, f"yolov3_ckpt_{ema_e}.pt#ema")
            arm = "ema"
    return pick, arm, raw_v, raw_e


def train_cmd(args, phase: int, lr: float, epochs: int,
              pretrained: str | None):
    tag = args.tag
    cmd = [
        sys.executable, "-m", "amyloid_yolo_tpu_torch.cli", "train",
        "--data_config", args.data_config,
        "--epochs", str(epochs),
        "--batch_size", str(args.batch_size),
        "--gradient_accumulations", str(args.gradient_accumulations),
        "--img_size", str(args.img_size),
        "--burn_in", str(args.burn_in),
        "--grad_clip_norm", str(args.grad_clip_norm),
        "--compute_dtype", args.compute_dtype,
        "--cache_images", "True", "--host_resize", "True",
        "--learning_rate", f"{lr:g}",
        "--checkpoint_dir", os.path.join(args.out_root,
                                         f"checkpoints_{tag}_p{phase}"),
        "--logdir", os.path.join(args.out_root, f"logs_{tag}_p{phase}"),
        "--eval_nms_capacity", str(args.eval_nms_capacity),
    ]
    if args.keep_checkpoints is not None:
        cmd += ["--keep_checkpoints", str(args.keep_checkpoints)]
    if args.model_def:
        cmd += ["--model_def", args.model_def]
    if args.ema_decay is not None:
        cmd += ["--ema_decay", str(args.ema_decay)]
    if pretrained:
        cmd += ["--pretrained_weights", pretrained]
    return cmd + ["--device", args.device]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tag", required=True,
                    help="run tag; outputs go to checkpoints_<tag>_p{1,2} "
                         "and logs_<tag>_p{1,2} under --out_root")
    ap.add_argument("--data_config",
                    default="/tmp/prospective_data/custom.data")
    ap.add_argument("--out_root", default=REPO)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--gradient_accumulations", type=int, default=2)
    ap.add_argument("--img_size", type=int, default=416)
    ap.add_argument("--model_def", default=None,
                    help="darknet cfg for both phases AND the study overlay "
                         "(e.g. a re-anchored cfg from tools/estimate_anchors_torch.py)")
    ap.add_argument("--epochs1", type=int, default=80)
    ap.add_argument("--epochs2", type=int, default=50)
    ap.add_argument("--lr1", type=float, default=1e-3)
    ap.add_argument("--lr2", type=float, default=3e-4)
    ap.add_argument("--burn_in", type=int, default=100)
    ap.add_argument("--grad_clip_norm", type=float, default=10.0)
    ap.add_argument("--compute_dtype", default="bfloat16")
    ap.add_argument("--eval_nms_capacity", type=int, default=128)
    ap.add_argument("--keep_checkpoints", type=int, default=6)
    ap.add_argument("--ema_decay", type=float, default=None)
    ap.add_argument("--study", action="store_true",
                    help="the study-protocol parity overlay on the phase-2 winner: "
                         "raises, its real prospective data is not in the repository")
    ap.add_argument("--device", default="cuda",
                    help="passed to both train processes (cpu runs them on the CPU)")
    ap.add_argument("--skip_phase1", default=None, metavar="CKPT",
                    help="skip phase 1 and resume phase 2 from this "
                         "checkpoint (accepts '<dir>#ema')")
    ap.add_argument("--dry_run", action="store_true",
                    help="print the commands without running anything")
    args = ap.parse_args(argv)
    if args.study:
        raise NotImplementedError(
            "--study runs tools/run_ckpt_parity_study.py, which reads the 200 real "
            "prospective images and the annotators' pickles; those files are not in "
            "the repository (ROADMAP.md)")

    def run(cmd, what):
        print(f"[recipe_chain] {what}: {' '.join(cmd)}", flush=True)
        if args.dry_run:
            return 0
        return subprocess.call(cmd, cwd=REPO)

    win = args.skip_phase1
    if win is None:
        rc = run(train_cmd(args, 1, args.lr1, args.epochs1, None), "phase 1")
        if rc != 0:
            print(f"[recipe_chain] phase 1 exited {rc}", file=sys.stderr)
            return rc
        if args.dry_run:
            win = "<phase1-winner>"
        else:
            ev = latest_events(os.path.join(args.out_root,
                                            f"logs_{args.tag}_p1"))
            if ev is None:
                print("[recipe_chain] no phase-1 events", file=sys.stderr)
                return 1
            win, arm, v, e = pick_winner(
                ev, os.path.join(args.out_root,
                                 f"checkpoints_{args.tag}_p1"),
                args.ema_decay is not None)
            print(f"[recipe_chain] phase-1 winner ({arm}): {win} "
                  f"(best raw mAP {v:.4f} @ {e})", flush=True)

    rc = run(train_cmd(args, 2, args.lr2, args.epochs2, win), "phase 2")
    if rc != 0:
        print(f"[recipe_chain] phase 2 exited {rc}", file=sys.stderr)
        return rc

    if not args.dry_run:
        ev2 = latest_events(os.path.join(args.out_root,
                                         f"logs_{args.tag}_p2"))
        if ev2 is None:
            print("[recipe_chain] no phase-2 events", file=sys.stderr)
            return 1
        win2, arm2, v2, e2 = pick_winner(
            ev2, os.path.join(args.out_root, f"checkpoints_{args.tag}_p2"),
            args.ema_decay is not None)
        print(f"[recipe_chain] phase-2 winner ({arm2}): {win2} "
              f"(best raw mAP {v2:.4f} @ {e2})", flush=True)

    print("[recipe_chain] done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
