"""Self time of the sampling layer: the mean over the program's
``ecnf.solve`` spans in the traced window of their host time outside the
``ecnf.field`` spans they hold, in milliseconds (the draws, the weights'
packing, the integrator's arithmetic, the base density)."""
import harness

spans = harness.load_module(harness.HERE / "spans.py")


def read(ctx):
    solves = spans.named(ctx.traced, "ecnf.solve")
    if not solves:
        return None
    fields = spans.named(ctx.traced, "ecnf.field")
    self_s = [(e - s) - spans.overlap([(s, e)], fields) for s, e in solves]
    return 1e3 * sum(self_s) / len(solves)
