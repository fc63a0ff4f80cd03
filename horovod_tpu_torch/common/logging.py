"""Leveled, rank-tagged logging (reference: ``horovod/common/logging.{h,cc}``,
``LOG(level, rank)`` macros). A copy of ``horovod_tpu/common/logging.py``
under the logger name ``horovod_tpu_torch``; the rank comes from the
port's process group once ``init`` ran, else from the launcher's
environment."""

from __future__ import annotations

import logging
import os
import sys

_LOGGER = None


class _RankFilter(logging.Filter):
    """Resolve the rank (and active collective span) lazily, per record.

    The logger is frequently touched before the launcher's env setup (any
    import-time ``get_logger()`` call), and the old read-once-at-creation
    scheme then stamped ``[rank ?]`` on every later line. Per-record
    resolution reads the process group's rank once ``init`` ran, else the
    config precedence (``HVD_TPU_`` beats ``HOROVOD_``), and picks up the
    identity whenever it appears.

    ``record.span`` carries the thread's active per-collective span id
    (``horovod_tpu_torch.diagnostics.spans``) so a log line emitted inside a
    traced collective can be joined against other ranks' lines; empty
    otherwise, keeping untraced lines byte-identical to before."""

    def filter(self, record: logging.LogRecord) -> bool:
        from horovod_tpu_torch.common.basics import _state
        record.rank = str(_state.rank) if _state.initialized else \
            os.environ.get("HVD_TPU_RANK", os.environ.get("HOROVOD_RANK", "?"))
        record.span = ""
        try:
            from horovod_tpu_torch.diagnostics.spans import current_span
            span = current_span()
            if span:
                record.span = f" [span {span}]"
        except Exception:
            pass
        return True


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        from horovod_tpu_torch.common.config import get_config
        logger = logging.getLogger("horovod_tpu_torch")
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.addFilter(_RankFilter())
            # HOROVOD_LOG_HIDE_TIME drops the timestamp (reference knob)
            ts = "" if get_config().log_hide_timestamp else "[%(asctime)s] "
            h.setFormatter(logging.Formatter(
                f"{ts}[hvd-tpu] [rank %(rank)s]%(span)s "
                "%(levelname)s: %(message)s"))
            logger.addHandler(h)
        name = get_config().log_level
        if name == "TRACE":  # python logging has no TRACE tier
            name = "DEBUG"
        elif name == "FATAL":
            name = "CRITICAL"
        level = getattr(logging, name, logging.WARNING)
        logger.setLevel(level)
        _LOGGER = logger
    return _LOGGER

