"""Seconds of the program's Trainer construction: the scene's frames decoded
and their rays made, the model built, the rays made resident."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.spans.get("trainer_init_s")
