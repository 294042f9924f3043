"""The training window's model FLOPs (``portbench.flops.train_step``: three
forward passes a step, recomputation not counted) over its seconds, as a
share of the card's dense bf16 peak. The untraced window, also in a
``--trace 1`` run."""


def read(ctx):
    peak = ctx.get("peak")
    if ctx.get("kind") != "train" or not peak:
        return None
    return 100.0 * ctx["flops"] / ctx["window_s"] / peak["bf16_flops"]
