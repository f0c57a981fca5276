"""``SolveServer.stats()["launches"]`` over ``["completed"]``, both
counted over the window (a launch is a bucket's superblock, or a lone
request's ``run_converged``)."""


def read(ctx):
    if not ctx.get("server_completed"):
        return None
    return ctx["server_launches"] / ctx["server_completed"]
