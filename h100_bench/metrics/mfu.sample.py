"""Share of the card's peak that the sampling window's products reach: the
cell's work by the frozen formula, field evaluations of the timed window
times one evaluation's products, over the window's seconds, in percent."""


def read(ctx):
    if ctx.peaks is None or not ctx.timed.get("field_evals"):
        return None
    K, bf16 = ctx.work.sample_route(ctx.config, ctx.traffic)
    one = ctx.work.field_eval_flops(ctx.config, ctx.traffic["batch"], K, bf16)
    least = ctx.work.seconds_at_peak(one, ctx.peaks, ctx.config["matmul_precision"])
    return 100.0 * ctx.timed["field_evals"] * least / ctx.timed["seconds"]
