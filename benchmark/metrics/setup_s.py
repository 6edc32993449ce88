"""Seconds from the process's start to the window's start: imports, the
kernel library's load (its build in a fresh checkout), the circuit's build
and the cold and warm calls."""


def read(ctx):
    return ctx.setup_s
