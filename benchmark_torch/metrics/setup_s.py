"""setup_s: from the start of run.py to the window's first job: imports,
the cards' contexts, the kernel build or its load, the frame pool and the
looks, and one warm-up job of the cell's own shapes."""


def read(run):
    return run.setup_s
