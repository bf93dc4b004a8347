"""Process start to the first timed call: the CUDA context, the kernels built
or loaded, the frame pool made and pinned, and the warm-up calls."""


def read(run):
    return run.setup_s
