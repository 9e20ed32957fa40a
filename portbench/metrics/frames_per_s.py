"""Flow fields returned, per second of the window."""
from portbench.harness import readings


def read(run):
    return readings.rate(run, 'frames')
