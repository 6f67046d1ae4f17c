"""Seconds from a new map to knowing what moves: the whole window over
the map changes completed in it (the window ends on a change)."""


def read(ctx):
    changes = ctx.stats.get("changes", 0)
    return ctx.stats["window_s"] / changes if changes else None
