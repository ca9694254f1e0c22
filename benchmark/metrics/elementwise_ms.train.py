"""Device ms a training step in torch's elementwise kernels and reductions
(the model's and the shader's torch operations, the loss)."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.family_ms("elementwise")
