"""setup_s: host-clock seconds from the interpreter's start of the run
module to the window's start: imports, CUDA start-up, the inputs, the
problem with its forward at the true source, the first unit (which builds
the distance-field kernel with nvcc in a fresh checkout) and its wait."""


def read(run):
    return run.setup_s
