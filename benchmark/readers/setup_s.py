"""setup_s: process start to the window's start: imports, the card, the
kernel library (built on a checkout's first run), weights and traffic from
the seed, the program, its warm-up and graph captures (host clock)."""


def read(run):
    return run.setup_s
