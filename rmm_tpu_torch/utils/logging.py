"""Run logging: stdout and a JSONL metrics file (``rmm_tpu/utils/logging.py``
without wandb: one line per log call, ``{"step": N, "time": t, **metrics}``,
in ``<run_dir>/metrics.jsonl``, and the run's config in
``<run_dir>/config.json``)."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional


def logger_setup(log_dir: Optional[str] = None) -> None:
    """INFO logging to stdout, and to ``<log_dir>/logs.log`` when given."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir,
                                                         "logs.log")))
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)-5.5s] %(message)s",
                        handlers=handlers, force=True)


class RunLogger:
    def __init__(self, run_dir: str, config: Optional[dict] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self._f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f, default=str, indent=2)

    def log(self, metrics: dict, step: int) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec, default=float) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
