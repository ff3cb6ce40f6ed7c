"""Seconds from process start to the window's start: interpreter, CUDA
context, the kernel library (built on a checkout's first run, else loaded
from its cache), initialize with its warmup, the engine, the prologue and
the warm cycle."""


def read(ctx):
    return ctx["setup_s"]
