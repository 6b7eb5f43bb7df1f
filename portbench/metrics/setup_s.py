"""setup_s: host clock from the process's start to the window's start
(imports, card start-up, kernel build on a checkout's first run, the
scene's rendering and the warm-up view)."""


def read(ctx):
    return ctx.setup_s
