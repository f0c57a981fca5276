"""Interior points x sweeps of every solve completed in the window, over
the window's seconds, in billions (Gpt/s). A solve counts once its
result is synchronized."""


def read(ctx):
    if "work_points" not in ctx:
        return None
    return ctx["work_points"] / ctx["window_s"] / 1e9
