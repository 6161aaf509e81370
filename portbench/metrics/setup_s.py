"""Process start to the window's opening: imports, CUDA start, the
kernels' library, weights, warm-up and lead-in."""


def read(record):
    return record["setup_s"]
