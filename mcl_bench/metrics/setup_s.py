"""Process start to the window's start: imports, CUDA context, map, LUT
build on the card, node, warm-up and graph capture; host clock."""


def read(run):
    return run.setup_s
