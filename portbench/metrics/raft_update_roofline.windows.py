"""RAFT's refinement (models/raft.py::_refine): counted FLOPs over its
kernels' device time, as a share of the peak, %."""
from portbench.harness import readings


def read(run):
    return readings.roofline(run, 'windows', 'portbench.raft_update')
