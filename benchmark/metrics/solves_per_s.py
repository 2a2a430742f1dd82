"""solves_per_s: the samples of every call completed in the window, over
the window's seconds."""


def read(ctx):
    w = ctx.window
    if w is None or w.calls == 0:
        return None
    return w.units / w.seconds
