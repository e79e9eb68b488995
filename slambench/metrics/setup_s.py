"""Process start to the first timed frame: import and CUDA init, kernel
build or load, the lap's rendering, the session, graph capture and
warm-up."""


def read(win, setup_s):
    return setup_s
