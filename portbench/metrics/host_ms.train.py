"""host_ms.train: the host's milliseconds in ``Testbed.frame()`` over the
window's steps that do not fetch the scalars (every 16th does), from the
benchmark's own clock around each call, outside any trace."""


def read(ctx):
    return ctx["window"].get("host_ms")
