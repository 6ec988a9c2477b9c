"""Seconds from the process's start to the window: the interpreter, torch
and a CUDA context, the inputs and weights drawn on the card, the kernels
loaded from the checkout's build directory, and the warm-up."""


def read(ctx):
    return ctx.setup_s
