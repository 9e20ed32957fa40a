"""Process start to the first timed item: imports, weights, the extractor,
kernel libraries (built on a checkout's first run), the warm-up."""


def read(run):
    return run.setup_s
