"""Minimal progress bar (reference: hapi/progressbar.py; the port's copy
of ``paddle_tpu/hapi/progressbar.py``)."""
from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._file = file
        self._start = time.time()
        self._last_update = 0

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        now = time.time()
        msg = f"step {current_num}"
        if self._num:
            msg += f"/{self._num}"
        for k, v in (values or []):
            if isinstance(v, float):
                msg += f" - {k}: {v:.4f}"
            else:
                msg += f" - {k}: {v}"
        elapsed = now - self._start
        msg += f" - {elapsed:.0f}s"
        end = "\n" if (self._num and current_num >= self._num) or \
            self._verbose == 2 else "\r"
        self._file.write(msg + end)
        self._file.flush()
        self._last_update = now
