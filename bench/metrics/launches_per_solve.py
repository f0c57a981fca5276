"""Stencil kernel launches (``engine.policies.LAUNCHES``, every policy)
over the solves done in the window."""


def read(ctx):
    if "launches" not in ctx or not ctx.get("solves"):
        return None
    return ctx["launches"] / ctx["solves"]
