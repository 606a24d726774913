"""Run logging, counterpart of ``tlie_tpu/utils/logging.py``: a JSONL file
per run under ``log_dir`` (``./logs`` by default), one record per ``log``
call, ``{"t": unix time, "step": step, <metric>: value, ...}``, the same
records ``tlie_tpu`` writes.

The port keeps the local sink only.  A config with a ``wandb`` section
(``wandb_config``) logs locally all the same and says so once, as
``tlie_tpu`` does where the ``wandb`` package is missing; nothing is
uploaded, and ``wandb`` is never imported.  ``tlie_tpu``'s ``summary``
writes to W&B alone, so the port has none.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class RunLogger:
    """Metrics of one run appended to ``log_dir/<run_name>.jsonl`` (a
    ``/`` in the name becomes ``_``)."""

    def __init__(self, wandb_config: Optional[Dict[str, Any]] = None, run_name: str = "run",
                 log_dir: str = "./logs"):
        self.run_name = run_name
        if wandb_config is not None:
            print("[logging] W&B unavailable (the port has no W&B sink); logging locally")
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name.replace('/', '_')}.jsonl")
        self._file = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        rec = {"t": time.time(), "step": step, **{k: _to_py(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()

    def finish(self) -> None:
        if not self._file.closed:
            self._file.close()


def _to_py(v):
    """A number as a Python float (tensors and numpy scalars too), anything
    else as it is."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
