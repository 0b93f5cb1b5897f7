"""Metrics logging: JSONL always, TensorBoard when available.

The port's copy of the reference package's ``utils/logging.py``.  It
replaces the reference's hard TensorBoard dependency
(``utils/logger.py:6-22``) with an append-only JSONL event stream (readable
anywhere, no native deps) plus an optional TB writer when the package
exists.  Run directories are timestamped like the reference's.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple


class MetricsLogger:
    def __init__(self, log_dir: str = "logs"):
        stamp = time.strftime("%Y_%m_%d__%H_%M_%S")
        self.run_dir = os.path.join(log_dir, stamp)
        os.makedirs(self.run_dir, exist_ok=True)
        self.path = os.path.join(self.run_dir, "events.jsonl")
        self._fh = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(self.run_dir)
        except Exception:  # tensorboard absent or broken: JSONL only
            pass

    def log(self, scalars: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                try:
                    self._tb.add_scalar(k, v, step)
                except Exception:  # a value TensorBoard refuses; JSONL has it
                    pass

    # reference-compatible aliases (utils/logger.py:13-22)
    def scalar_summary(self, tag: str, value: float, step: int) -> None:
        self.log({tag: value}, step)

    def list_of_scalars_summary(self, tag_value_pairs: List[Tuple[str, float]],
                                step: int) -> None:
        self.log({t: v for t, v in tag_value_pairs}, step)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


__all__ = ["MetricsLogger"]
