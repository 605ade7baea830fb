"""setup_s: seconds from the process's start to the window's: imports,
the device claim, kernel loading, weights, traffic and warm-up."""


def read(run):
    return run.setup_s
