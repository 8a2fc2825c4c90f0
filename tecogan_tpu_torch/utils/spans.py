"""The port's named spans on the profiler's clock.

``with span("trunk"):`` marks the block as ``teco.trunk`` in a
``torch.profiler`` trace, exactly while a profiler is running
(``torch.autograd._profiler_enabled()``); otherwise ``span`` returns one
shared no-op context, so an untraced call pays one check and nothing
else.  There is no switch: a profiler started around any entry point
(``tools/profile_train.py``, the CLI's ``--profile_dir``, a caller's own
``torch.profiler.profile``) sees the spans.

A span is a profiler op (``RecordFunctionFast``, the function scope), the
kind ``aten::conv2d`` is: the trace holds it on the host thread that
entered it, with its begin and end on kineto's clock, and the ops and
launch calls inside it as its children.  A kernel belongs to the span
whose instance holds its launch call; kineto gives the launch and the
kernel the same correlation id.  Unlike ``record_function``'s user
annotations, a span has no copy on the device's timeline, so a reading
of the device's activity counts kernels, copies and memsets only.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

PREFIX = "teco."
_OFF = nullcontext()


def span(name: str):
    """The context that records ``teco.<name>`` under a running profiler;
    the shared no-op context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(PREFIX + name)
    return _OFF
