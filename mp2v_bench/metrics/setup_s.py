"""setup_s (end to end, host clock): from the start of the process to the
first timed picture, less the time the stream took to make: imports, the
CUDA context, the kernel library (built on a checkout's first run), the
decoder and its warm-up."""


def read(w):
    return w.setup_s
