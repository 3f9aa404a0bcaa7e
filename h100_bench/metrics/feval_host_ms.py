"""Host time of a field evaluation: the mean duration of the program's
``ecnf.field`` spans in the traced window, in milliseconds.  It is the
time the host takes to issue one evaluation, under the profiler."""
import harness

spans = harness.load_module(harness.HERE / "spans.py")


def read(ctx):
    fields = spans.named(ctx.traced, "ecnf.field")
    if not fields:
        return None
    return 1e3 * sum(e - s for s, e in fields) / len(fields)
