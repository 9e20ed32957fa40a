"""Share of the traced window in which no kernel or copy ran, %."""
from portbench.harness import readings


def read(run):
    return readings.device_idle(run, 'frames')
