"""Share of the traced window in which no operation ran on the device:
1 - (union of the device's operation intervals) / (window), in percent."""


def read(ctx):
    if not ctx.traced["device_ops"]:
        return None
    return 100.0 * (1.0 - ctx.traced["busy_s"] / ctx.traced["window_s"])
