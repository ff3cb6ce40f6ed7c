"""MD steps a fused cell-pair chunk (kernel 15, or 16 where the engine
width-lists its pencils) advances: the program's host-side tally of the
chunks it issued and their steps (``PENCIL_CHUNKS`` beside ``HOST_READS``
in ``ljmd_tpu_torch.models.engine``; no device read), steps over chunks.

The tally runs from the process's start: the warm cycle and the window
(and a prologue, where the cell has one). The engine sizes its chunk once,
when it is built, so every cycle issues the same chunks and the ratio is
the window's. Nothing where the program keeps no such tally or issued no
fused chunk."""


def read(ctx):
    if ctx["traced"] is None:
        return None
    try:
        from ljmd_tpu_torch.models.engine import PENCIL_CHUNKS
    except ImportError:
        return None
    if not PENCIL_CHUNKS["chunks"]:
        return None
    return PENCIL_CHUNKS["steps"] / PENCIL_CHUNKS["chunks"]
