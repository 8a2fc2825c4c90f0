"""host_issue_ms.live: the mean host ms of the span from a frame's step
call to the return of its uint8 conversion, before the copy to the host
(the benchmark's span, host clock)."""


def read(ctx):
    if ctx.mode != "live" or not ctx.run["records"]:
        return None
    recs = ctx.run["records"]
    return sum(issued - start for _, _, _, start, issued, _ in recs) / len(recs) * 1e3
