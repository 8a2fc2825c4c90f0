"""archive_fps: the frames that reached the host sink in the window, over
the window's length (host clock)."""


def read(ctx):
    if ctx.mode != "archive":
        return None
    return ctx.run["frames"] / ctx.run["window_s"]
