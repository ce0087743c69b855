"""setup_s: process start to the window's first query: load, upload,
warm-up, and in a process that compiles, the kernels' build. The first run in
a checkout also builds the collection's index; that build is logged apart and
left out, as a deployment builds its index offline."""


def read(ctx):
    return ctx.setup_s
