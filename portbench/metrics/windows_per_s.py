"""16-frame windows whose rgb||flow row reached its .npy, per second of the
window."""
from portbench.harness import readings


def read(run):
    return readings.rate(run, 'windows')
