"""Process groups in place of the JAX device mesh
(tecogan_tpu/parallel/mesh.py).

JAX runs one SPMD program over a ``(slice, data, model)`` mesh of
devices.  The port runs one process a rank, each driving one device (one
card a rank under NCCL, or the CPU under gloo), joined by a
``torch.distributed`` process group; :class:`Mesh` names this process's
place in it.  The grid is JAX's ``reshape(n_data, n_model)``: rank r has
data index ``r // n_model`` and model index ``r % n_model``; the ranks of a
model group share a data index (the same samples, each its channel slice
of the sharded convs, ``parallel/tp.py``), the ranks of a data group share
a model index.  ``n_slice`` only enlarges the data axis, since NCCL picks
its own rings.

* :func:`spawn` starts the ranks (start method ``spawn``, ``file://``
  rendezvous) and runs ``fn(device, *args)`` on each.
* :func:`make_mesh` keeps the JAX function's shape checks and returns the
  :class:`Mesh` of the calling rank.
* :func:`shard_batch` / :func:`shard_multi_batch` take the rank's slice of
  the batch dim (dim 0, or dim 1 of ``(K, B, ...)``), the placement JAX's
  ``batch_sharding`` / ``multi_batch_sharding`` name; :func:`replicate_state`
  broadcasts a state's tensors from rank 0 (JAX's ``replicated``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..engine.state import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) grid of ranks.

    ``rank`` is its data index, its index in ``group``, the data group of
    the ranks with its model index (None when the process is not a member:
    :func:`make_mesh` over fewer ranks than the world); ``group`` is None
    for a world of one process and for a data axis of one rank beside a
    model axis, where every collective is the identity.  ``model_rank`` is
    its index in ``model_group``, the ranks with its data index;
    ``model_group`` is None when ``n_model`` is 1."""

    n_data: int
    n_slice: int
    rank: Optional[int]
    device: torch.device
    group: Optional[Any]
    n_model: int = 1
    model_rank: Optional[int] = 0
    model_group: Optional[Any] = None

    @property
    def size(self) -> int:
        """The number of data ranks the batch (or the rows) is split over."""
        return self.n_data * self.n_slice

    @property
    def member(self) -> bool:
        return self.rank is not None

    def shard_slice(self, batch: int) -> slice:
        """This rank's part of a dim of size ``batch``."""
        if batch % self.size:
            raise ValueError(f"batch {batch} is not divisible by the {self.size} ranks")
        b = batch // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def _rank_device(device, rank: int) -> torch.device:
    """``"cuda"`` (no index) is one card a rank; an indexed device or the
    CPU is the same device for every rank."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, fn: Callable, world: int, device, backend: str,
               init_file: str, args: tuple) -> None:
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, device, init_file: str,
          backend: Optional[str] = None, args: tuple = ()) -> None:
    """Run ``fn(rank_device, *args)`` in ``world`` new processes (start
    method ``spawn``), each a rank of one default process group.

    ``device``: ``"cuda"`` gives rank r the card ``r % device_count``, an
    indexed card (``"cuda:0"``) or ``"cpu"`` is every rank's device (CPU
    ranks run one thread each).  ``backend`` defaults to NCCL for CUDA
    ranks and gloo for CPU ranks, and is only ever what it says: nothing
    falls back to gloo when NCCL fails.  ``init_file`` is the rendezvous file
    (``file://``); it must not exist yet.  ``fn`` is pickled by its import
    path.  A SIGTERM to this process is passed on to the ranks while they
    run.  Raises as ``torch.multiprocessing.spawn`` does when a rank
    fails (the others are stopped)."""
    if os.path.exists(init_file):
        raise ValueError(f"rendezvous file {init_file} exists; give a fresh path")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    ctx = mp.start_processes(_rank_main, args=(fn, world, device, backend, init_file, args),
                             nprocs=world, join=False, start_method="spawn")

    def forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: nothing to forward from
        prev = None
    try:
        while not ctx.join():
            pass
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None, n_slice: int = 1,
              device=None) -> Mesh:
    """The calling rank's :class:`Mesh` over the ranks of the default
    process group (a world of one when none is initialized).

    ``n_data=None`` (or <= 0) uses every rank left by ``n_model`` on the
    data axis; ``devices``, one a rank, sets how many are visible (default:
    the world size).  A mesh over fewer ranks than the world is built of
    new groups of the first ranks; the others get a mesh with ``rank`` and
    ``model_rank`` None.  Every rank must call this alike: with
    ``n_model > 1`` it creates every data group and then every model group,
    in that order, as ``dist.new_group`` needs.  ``device`` is this rank's
    device (default: the card, ``engine.state.resolve_device``)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    visible = len(devices) if devices is not None else world
    if n_data is None or n_data <= 0:
        n_data = visible // (n_model * n_slice)
    use = n_data * n_model * n_slice
    if use > visible:
        raise ValueError(
            f"mesh {n_slice}x{n_data}x{n_model} needs {use} devices, "
            f"only {visible} visible")
    if use > world:
        raise ValueError(f"mesh of {use} ranks in a world of {world} processes")
    dev = resolve_device(device if device is not None or devices is None
                         else devices[rank])
    if not initialized:
        return Mesh(n_data, n_slice, 0, dev, None)
    if n_model == 1:
        if use == world:
            return Mesh(n_data, n_slice, rank, dev, dist.group.WORLD)
        group = dist.new_group(list(range(use)))
        return Mesh(n_data, n_slice, rank if rank < use else None, dev,
                    group if rank < use else None)
    n_rows = n_data * n_slice
    data_groups = [dist.new_group([d * n_model + m for d in range(n_rows)])
                   if n_rows > 1 else None for m in range(n_model)]
    model_groups = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                    for d in range(n_rows)]
    if rank >= use:
        return Mesh(n_data, n_slice, None, dev, None, n_model, None, None)
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_slice, d, dev, data_groups[m], n_model, m, model_groups[d])


def shard_batch(mesh: Mesh, *arrays):
    """Each array's slice of dim 0 for this rank, as a tensor on the
    mesh's device (numpy arrays or tensors in)."""
    out = tuple(torch.as_tensor(a)[mesh.shard_slice(a.shape[0])].to(mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_multi_batch(mesh: Mesh, *arrays):
    """Each ``(K, B, ...)`` array's slice of dim 1 (the batch) for this
    rank, on the mesh's device: the inputs of ``build_dp_multi_train_step``."""
    out = tuple(torch.as_tensor(a)[:, mesh.shard_slice(a.shape[1])].to(mesh.device)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def _map_tensors(fn: Callable, tree):
    """``tree`` with every tensor leaf replaced by ``fn(leaf)``, in a fixed
    order (dicts in insertion order); dataclasses, named tuples, lists and
    tuples are rebuilt, other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tensors(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def replicate_state(mesh: Mesh, state):
    """``state`` (a train state, a dict of tensors, a qtail: any tree of
    tensors) on the mesh's device with every tensor broadcast from rank 0
    of the grid, so the ranks hold the same values.  Every rank must pass
    a tree of the same structure and shapes; leaves that are not tensors
    are kept."""
    def bcast(t):
        t = t.to(mesh.device, copy=True)
        # over the data group from data index 0, then over the model group
        # from model index 0: every rank ends with the grid's rank 0 values
        for group in (mesh.group, mesh.model_group):
            if group is not None:
                dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    return _map_tensors(bcast, state)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every rank of the mesh (pickled; tensors travel
    on the CPU and come back there); other ranks' ``obj`` is ignored."""
    if mesh.group is None:
        return obj
    box = [_map_tensors(lambda t: t.detach().cpu(), obj) if mesh.rank == 0 else None]
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group,
                               device=mesh.device if mesh.device.type == "cuda" else None)
    return box[0]
