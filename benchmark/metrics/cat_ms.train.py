"""Device ms a training step in torch.cat's copies (the shader input, the fused tables)."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.family_ms("cat")
