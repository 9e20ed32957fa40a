"""The process's age: set-up is timed from the process's start, which the
kernel records, so the interpreter's own start-up counts too."""
from __future__ import annotations

import os
import time

_IMPORTED = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc; elsewhere since
    this module was imported)."""
    try:
        with open('/proc/self/stat') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        started = int(fields[19]) / os.sysconf('SC_CLK_TCK')
        with open('/proc/uptime') as f:
            return float(f.read().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED
