"""setup_s (s): process start to the first timed unit: interpreter and
CUDA start, the graph, the weights, the kernels' load (their build in a
checkout's first run) and the warm-up, which for a training cell is the
checked steps."""


def read(ctx):
    return ctx.setup_s
