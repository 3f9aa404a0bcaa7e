"""Device kernels (copies and fills left out) in the traced window, per
field evaluation of its solves (the solver's attempts times the stages)."""


def read(ctx):
    evals = ctx.traced.get("field_evals")
    if not evals or not ctx.kernels:
        return None
    return len(ctx.kernels) / evals
