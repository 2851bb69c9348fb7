"""setup_s: from the process's start to the first timed frame: imports,
CUDA context, kernel libraries (built on a checkout's first run, loaded
from its build cache after), scene written or read, BVH, LTC and noise
tables, warm-up frames."""


def read(run):
    return run.setup_s
