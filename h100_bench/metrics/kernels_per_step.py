"""Device kernels (copies and fills left out) in the traced window, per
train step."""


def read(ctx):
    steps = ctx.traced.get("steps")
    if not steps or not ctx.kernels:
        return None
    return len(ctx.kernels) / steps
