"""Images of the training steps dispatched in the window, over the seconds
until the card finished them."""


def read(ctx):
    r = ctx.result
    return r["images"] / r["seconds"] if r["kind"] == "training" else None
