"""host_issue_ms.archive: host ms a frame that the serving thread spent
outside the CUDA runtime's synchronising calls, over the traced window
(the device trace's host events)."""


def read(ctx):
    if ctx.mode != "archive" or ctx.trace is None or not ctx.run["frames"]:
        return None
    t = ctx.trace
    return (t["window_s"] - t["blocked_s"]) / ctx.run["frames"] * 1e3
