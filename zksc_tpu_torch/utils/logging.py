"""Structured logging + tracing for the port (SURVEY.md §5 metrics/
observability: the reference threads an optional console-shaped Logger
through all APIs, js/src/types.ts:305).

Two pieces, as in the JAX package's ``utils/logging.py``:
  - Logger: a tiny structured logger protocol (debug/info/warn/error with
    key-value fields), default writes one JSON line per event to stderr
    when ZKSC_LOG is set (silent otherwise, like the reference default).
  - trace_span: wall-clock span timing that also drives torch.profiler
    when ZKSC_TRACE_DIR is set (a Chrome trace per span, with the CUDA
    kernels of the span when a card is present), so prover hot paths can be
    profiled without code edits.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time


class Logger:
    """Console-shaped structured logger. Subclass or pass a custom instance
    anywhere a `logger=` parameter is accepted."""

    LEVELS = ("debug", "info", "warn", "error")

    def __init__(self, min_level: str = "debug", stream=None):
        self._min = self.LEVELS.index(min_level)
        self._stream = stream

    def log(self, level: str, msg: str, **fields):
        if self.LEVELS.index(level) < self._min:
            return
        rec = {"ts": round(time.time(), 3), "level": level, "msg": msg}
        rec.update(fields)
        print(json.dumps(rec, default=str),
              file=self._stream or sys.stderr, flush=True)

    def debug(self, msg, **f):
        self.log("debug", msg, **f)

    def info(self, msg, **f):
        self.log("info", msg, **f)

    def warn(self, msg, **f):
        self.log("warn", msg, **f)

    def error(self, msg, **f):
        self.log("error", msg, **f)


class _SilentLogger(Logger):
    def log(self, level, msg, **fields):
        pass


def default_logger() -> Logger:
    """ZKSC_LOG=debug|info|warn|error enables stderr JSON logging; unset
    keeps the library silent (reference default: no logger supplied)."""
    lvl = os.environ.get("ZKSC_LOG", "")
    if lvl in Logger.LEVELS:
        return Logger(min_level=lvl)
    return _SilentLogger()


@contextlib.contextmanager
def trace_span(name: str, logger: Logger | None = None, **fields):
    """Time a span; if ZKSC_TRACE_DIR is set, also profile it with
    torch.profiler and write the Chrome trace ZKSC_TRACE_DIR/<name>.json.
    The span is a ``record_function`` range in the trace and, with CUDA, an
    NVTX range too; with CUDA the profiler records the card's kernels.
    Exceptions from the body propagate (no trace is written then)."""
    logger = logger or default_logger()
    trace_dir = os.environ.get("ZKSC_TRACE_DIR")
    t0 = time.time()
    if trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(name), (torch.cuda.nvtx.range(name) if cuda
                                         else contextlib.nullcontext()):
                yield
            if cuda:
                torch.cuda.synchronize()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    else:
        yield
    logger.debug("span", span=name, seconds=round(time.time() - t0, 4),
                 **fields)
