"""Share of the traced window in which the device is idle while the host
is inside one of the program's ``ecnf.field`` spans, in percent: the
field spans' time less the part of it the device's operations cover, over
the window."""
import harness

spans = harness.load_module(harness.HERE / "spans.py")


def read(ctx):
    fields = spans.named(ctx.traced, "ecnf.field")
    if not fields or not ctx.traced["device_ops"]:
        return None
    device = [(s, e) for _, s, e in ctx.traced["device_ops"]]
    idle = spans.length(fields) - spans.overlap(fields, device)
    return 100.0 * idle / ctx.traced["window_s"]
