"""step.mfu: model FLOPs of the window's steps over the card's dense bf16
peak for the window's length (%). The FLOPs are the benchmark's own count
on its plain model at the cell's shapes: the key pass forward on 2B
clips, the query forward and backward on B; recomputation not counted."""


def read(ctx):
    if not ctx.steps:
        return None
    y = ctx.yardstick
    return 100.0 * ctx.work.flops * ctx.steps / (ctx.window_s
                                                 * y.PEAK_BF16_FLOPS)
