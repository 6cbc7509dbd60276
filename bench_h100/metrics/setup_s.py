"""setup_s: seconds from the process's start to the window's start
(loading, weights, kernel builds on a first run, warm-up)."""


def read(rec):
    return rec.setup_s
