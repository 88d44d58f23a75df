"""Seconds from the process's start to the end of the warm-up: imports,
the corpus and the stream, the table's build and upload, the kernels'
build where it is not cached yet, the warm-up requests."""


def read(ctx):
    return ctx.setup_s
