"""Both I3D towers (models/i3d.py::forward): counted FLOPs over their
kernels' device time, as a share of the peak, %."""
from portbench.harness import readings


def read(run):
    return readings.roofline(run, 'windows', 'portbench.i3d_towers')
