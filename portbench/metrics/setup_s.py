"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the kernels' libraries (built by the first run of a checkout),
weights, inputs and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
