"""Training log: the port of ``rtdsd_tpu/utils/logging.py``.

``Logger.wandbLog`` appends every record to a local ``metrics.jsonl`` and,
when wandb is enabled in ``SysConfig`` and importable, logs it there too;
wandb failing to import or start is never fatal.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class Logger:
    def __init__(self, sys_config=None, metrics_path: Optional[str] = None):
        self.wandb_disabled = bool(getattr(sys_config, "wandb_disabled", True))
        self._wandb = None
        self._metrics_file = None
        if metrics_path:
            os.makedirs(os.path.dirname(metrics_path) or ".", exist_ok=True)
            self._metrics_file = open(metrics_path, "a")
        if sys_config is not None and not self.wandb_disabled:
            try:
                import wandb

                if getattr(sys_config, "wandb_key", ""):
                    wandb.login(key=sys_config.wandb_key)
                wandb.init(project=sys_config.wandb_project,
                           entity=sys_config.wandb_entity or None,
                           name=sys_config.wandb_name,
                           notes=sys_config.wandb_notes)
                self._wandb = wandb
            except Exception as e:      # absent or offline: never fatal
                self.print(f"[logger] wandb disabled ({type(e).__name__}: {e})")

    def wandbLog(self, contents: dict, step: Optional[int] = None) -> None:
        if self._metrics_file is not None:
            rec = {"t": time.time(),
                   **{k: _tofloat(v) for k, v in contents.items()}}
            if step is not None:
                rec["step"] = step
            self._metrics_file.write(json.dumps(rec) + "\n")
            self._metrics_file.flush()
        if self._wandb is not None:
            self._wandb.log(contents, step=step)

    def print(self, *args) -> None:
        print(*args, flush=True)

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None


def _tofloat(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
