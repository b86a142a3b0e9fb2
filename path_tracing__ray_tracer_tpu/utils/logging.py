"""Structured logging — this package's replacement for the reference's ad-hoc
``print()`` status text (SURVEY.md §5 "metrics/logging"): same facts (object
counts, atlas sizes, launch geometry, timing, Mrays/sec) as key-value events.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time

_logger = logging.getLogger("ptrt")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(os.environ.get("PTRT_LOG_LEVEL", "INFO").upper())


def log_event(event: str, **fields):
    record = {"event": event, "ts": round(time.time(), 3), **fields}
    _logger.info(json.dumps(record, default=str))


def set_level(level: str):
    _logger.setLevel(level.upper())
