"""setup_s (host clock): from the process's start to the window's first
submit: imports, the card, the kernels' libraries (built on a checkout's
first run), the weights drawn on the card, the engine and its deployment,
and the warm-up prefills."""


def read(ctx):
    return ctx.setup_s
