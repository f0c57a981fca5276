"""Requests completed in the window, with their results on the host,
over the window's seconds."""


def read(ctx):
    if "served_completed" not in ctx:
        return None
    return ctx["served_completed"] / ctx["window_s"]
