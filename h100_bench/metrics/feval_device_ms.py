"""Device time of a field evaluation: the union of the device operations
that the program's ``ecnf.field`` spans launched in the traced window,
over the number of those spans, in milliseconds."""
import harness

spans = harness.load_module(harness.HERE / "spans.py")


def read(ctx):
    fields = spans.named(ctx.traced, "ecnf.field")
    ops = spans.launched_in(ctx.traced, fields) if fields else None
    if not ops:
        return None
    return 1e3 * spans.length(ops) / len(fields)
