"""Process start to the first timed solve: imports, the CUDA context,
loading (or, in a fresh checkout, building) the kernels, the grids from
the seed and the warm-up of this cell's own shapes."""


def read(ctx):
    return ctx["setup_s"]
