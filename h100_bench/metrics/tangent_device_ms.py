"""Device time of the structured trace's tangent pass, per field
evaluation: the union of the device operations that the program's
``ecnf.field.tangent`` spans launched in the traced window, over the number
of ``ecnf.field`` spans, in milliseconds.  Beside `feval_device_ms` it
splits an evaluation's device time between the tangent pass and the rest
(the residual-capturing primal, the trace's sum).  A program without the
spans, or a route that runs no tangent pass, reports nothing."""
import harness

spans = harness.load_module(harness.HERE / "spans.py")


def read(ctx):
    fields = spans.named(ctx.traced, "ecnf.field")
    tangents = spans.named(ctx.traced, "ecnf.field.tangent")
    ops = spans.launched_in(ctx.traced, tangents) if fields and tangents else None
    if not ops:
        return None
    return 1e3 * spans.length(ops) / len(fields)
