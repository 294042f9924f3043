"""The share of the training window spent in the ADCC layer's own work on
the trainer's thread: the ledger's appends (each with its fsync) and
the synchronous host copies of the slot steps, from the trainer's
``timings``, over the window's seconds (the untraced window, also in a
``--trace 1`` run)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    t = ctx["timings"]
    if not t["ledger_append"] and not t["host_copy"]:
        return None
    return 100.0 * (sum(t["ledger_append"]) + sum(t["host_copy"])) \
        / ctx["window_s"]
