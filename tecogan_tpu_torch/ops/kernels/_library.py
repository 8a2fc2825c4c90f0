"""The ``tecogan_tpu_torch`` operator namespace: each hand kernel is a
``torch.library`` operator with a CUDA kernel (the launch wrapper, which
raises on what the kernel does not take), a CPU kernel (the plain
version) and a fake (the output's shape, dtype and strides, for
``torch.export`` and other tracing), registered through the dispatcher's
own ``Library`` API, whose call costs a few microseconds less than
``torch.library.custom_op``'s wrappers (the int8 tail makes 39 calls a
frame)."""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "tecogan_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")  # kept alive: it holds the registrations


def register(name: str, schema: str, cuda: Callable, cpu: Callable,
             fake: Callable) -> torch._ops.OpOverload:
    """Define ``tecogan_tpu_torch::<name><schema>`` with its CUDA and CPU
    kernels and its fake; returns the operator (``.default``)."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
