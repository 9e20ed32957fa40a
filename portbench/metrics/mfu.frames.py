"""The flow fields' counted FLOPs over the window's seconds, as a share of
the peak, %."""
from portbench.harness import readings


def read(run):
    return readings.mfu(run, 'frames')
