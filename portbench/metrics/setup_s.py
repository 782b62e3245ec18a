"""setup_s: seconds from process start until the window opens (the
inputs made from the seed, the kernels loaded or built, the warm-up)."""


def read(r):
    return r.setup_s
