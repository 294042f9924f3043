"""The rate of the slot steps' synchronous copy of the training state to
the host: the bytes of one slot (float32 parameters, AdamW's two
moments and its step) over the trainer's ``timings["host_copy"]``."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["timings"]["host_copy"]:
        return None
    copies = ctx["timings"]["host_copy"]
    return ctx["slot_bytes"] * len(copies) / sum(copies) / 1e9
