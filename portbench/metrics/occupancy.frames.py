"""Valid flow pairs over the batch slots of the steps the loop launched, %."""
from portbench.harness import readings


def read(run):
    return readings.occupancy(run, 'frames')
