"""Process start to the first timed iteration: imports, the CUDA context,
kernels loaded from the checkout's build cache (built there by the first
run), the networks' weights from the seed, the env reset, and the checked
iterations."""

UNIT = "s"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
