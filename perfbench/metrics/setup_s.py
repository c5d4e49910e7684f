"""setup_s: from the process's start to the first timed call (imports,
CUDA's start, the kernels' loading or building, the inputs, the warm-up
calls), host clock."""


def read(run):
    return run.setup_s
