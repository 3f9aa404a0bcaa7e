"""Share of the card's peak that the training window's products reach: the
frozen formula of one step's products, times the steps of the timed
window, over its seconds, in percent."""


def read(ctx):
    if ctx.peaks is None or not ctx.timed.get("steps"):
        return None
    if ctx.traffic["microbatch"] != 1:
        return None  # the formula is the one-shot step's
    one = ctx.work.train_step_flops(ctx.config, ctx.traffic["batch"])
    least = ctx.work.seconds_at_peak(one, ctx.peaks, ctx.config["matmul_precision"])
    return 100.0 * ctx.timed["steps"] * least / ctx.timed["seconds"]
