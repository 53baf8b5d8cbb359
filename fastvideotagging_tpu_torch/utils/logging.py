"""Structured logging (a copy of ``fastvideotagging_tpu/utils/logging.py``).

Console lines mirror the reference's train-log style (epoch/batch, loss,
accuracy, samples/sec); a JSONL sink makes the same scalars machine-readable.
"""

from __future__ import annotations

import json
import logging
import sys
import time


def get_logger(name: str = "fvt") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsLogger:
    """Writes metric dicts as JSONL and human-readable console lines."""

    def __init__(self, jsonl_path: str | None = None, logger_name: str = "fvt",
                 enabled: bool = True):
        # enabled=False -> a no-op sink (multi-host: metrics are identical on
        # every process, so only process 0 logs; fit passes the flag).
        self.logger = get_logger(logger_name)
        self.enabled = enabled
        self._file = open(jsonl_path, "a") if (jsonl_path and enabled) else None

    def log(self, step: int, **scalars) -> None:
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time(), **scalars}
        if self._file:
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        pretty = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in scalars.items()
        )
        self.logger.info("step %d %s", step, pretty)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
