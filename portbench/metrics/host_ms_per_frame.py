"""The program's decode+preprocess stage (Tracer) in the window, ms per
flow field delivered."""
from portbench.harness import readings


def read(run):
    return readings.host_ms(run, 'frames')
