"""Data parallel over ``torch.distributed``: the pixel batch sharded over
ranks, the grids replicated, the loss and gradient grids averaged.

Port of ``uivr_tpu/parallel/dist.py``.  JAX runs one program over a mesh
of devices; here each rank is a process with one device (rank r takes
``cuda:r % device_count``, or the CPU when asked), and :class:`Mesh`
records the group, the world size, the rank and its device.  The batch
(sensor ids, pixels, reference values) is cut into equal contiguous
blocks, rank r taking block r as ``NamedSharding(P(axis))`` cuts it; each
rank mixes the step's seeds with its shard index exactly as the reference
does; the loss and every gradient grid are summed over the ranks by
all-reduce and divided by the world size (``pmean``).  Every rank receives
the same reduced bits, so Adam and the projection, which are
deterministic, leave the grids equal on every rank although the kernels'
gradient scatter (float atomics) sums in a different order on each.

Backends: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU or when ranks share a card (NCCL refuses two ranks on one device;
gloo stages CUDA tensors through the host).
"""
from __future__ import annotations

import datetime
import socket
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..core.rng import sample_tea_32

# rank 0 renders the references and previews and writes the checkpoints
# while the other ranks wait in a collective: allow for long ones
TIMEOUT = datetime.timedelta(hours=2)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data-parallel mesh."""
    size: int                    # world size
    rank: int
    device: torch.device         # this rank's device
    axis: str = "rays"
    group: Optional[object] = None   # the process group; None for one process

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda:rank % device_count``, or the CPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(device, world_size: int) -> str:
    """``nccl`` when each of ``world_size`` ranks has a card of its own,
    else ``gloo``."""
    device = resolve_device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> Optional[str]:
    """Join the group of ``num_processes`` ranks whose rank 0 serves the
    rendezvous at ``coordinator_address`` (``host:port``) as rank
    ``process_id``, on ``device``'s kind (default ``cuda``).  Prints and
    returns the backend.  A no-op returning None for a single process
    without an address, as the reference's."""
    if num_processes is None or (num_processes <= 1 and coordinator_address is None):
        return None
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs coordinator_address and "
                         "process_id for more than one process")
    dev = rank_device(device, process_id)
    backend = choose_backend(dev, num_processes)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    print(f"[dist] rank {process_id}/{num_processes}: {backend} on {dev}", flush=True)
    return backend


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays", device=None) -> Mesh:
    """This rank's :class:`Mesh` over the process group (one rank when no
    group was initialized).  ``n_devices`` must equal the group's size:
    where JAX slices its device list, the port raises ValueError."""
    if dist.is_initialized():
        size, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        size, rank, group = 1, 0, None
    if n_devices is not None and n_devices != size:
        raise ValueError(f"make_mesh({n_devices}): the process group has {size} rank(s); "
                         "start one process per rank and call initialize_distributed")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(size=size, rank=rank, device=dev, axis=axis, group=group)


def _tree_map(fn, tree):
    """``fn`` on every tensor (numpy arrays as tensors) of a tree of
    named tuples, tuples, lists and dicts; other leaves unchanged."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` on ``mesh.device``, broadcast from rank 0
    (copies: the caller's tensors are not written)."""
    def put(x):
        x = x.to(mesh.device, copy=True).contiguous()
        if mesh.group is not None:
            dist.broadcast(x, src=0, group=mesh.group)
        return x
    return _tree_map(put, tree)


def shard_batch(mesh: Mesh, tree, axis: str = "rays"):
    """This rank's contiguous block of the leading dimension of every
    tensor of ``tree``, on ``mesh.device``; scalars whole.  Raises
    ValueError where the leading dimension does not divide by the world
    size (the mean of the shards' losses is then not the batch's)."""
    _check_axis(mesh, axis)

    def cut(x):
        if x.ndim == 0:
            return x.to(mesh.device)
        n = x.shape[0]
        if n % mesh.size:
            raise ValueError(f"a leading dimension of {n} does not divide over "
                             f"{mesh.size} ranks")
        k = n // mesh.size
        return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)
    return _tree_map(cut, tree)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")


def local_seeds(mesh: Mesh, seed, seed_grad):
    """The shard's (seed, seed_grad): TEA of the step's seeds with
    ``2 shard + 1`` and ``2 shard + 2``, as the reference mixes them."""
    s, _ = sample_tea_32(seed, 2 * mesh.rank + 1)
    g, _ = sample_tea_32(seed_grad, 2 * mesh.rank + 2)
    return s, g


def sharded_loss_and_grad(mesh: Mesh, render: Callable, loss: Callable,
                          axis: str = "rays"):
    """The sharded value-and-grad of ``loss(render(...), ref)``:

        value, grads = vag(params, emitter, cameras, sensor_idx, pixels, ref,
                           seed, seed_grad)

    with this rank's shard of (sensor_idx, pixels, ref) (:func:`shard_batch`)
    and the step's global seeds.  ``render`` is the differentiable batch
    render (``render.batched.make_render``).  The value and the gradients
    returned are the means over the ranks, the same on every rank."""
    _check_axis(mesh, axis)

    def vag(params, emitter, cameras, sensor_idx, pixels, ref, seed, seed_grad):
        s, g = local_seeds(mesh, seed, seed_grad)
        leaves = type(params)(*[p.detach().requires_grad_(True) for p in params])
        value = loss(render(leaves, emitter, cameras, sensor_idx, pixels, s, g), ref)
        grads = torch.autograd.grad(value, leaves)
        out = [value.detach().reshape(1)] + [x.contiguous() for x in grads]
        if mesh.group is not None:
            for x in out:      # the same order on every rank
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
        out = [x / mesh.size for x in out]
        return out[0].reshape(()), type(params)(*out[1:])

    return vag


def on_rank0(mesh: Optional[Mesh], fn: Callable):
    """Run ``fn()`` on rank 0 (or without a mesh) while the other ranks
    wait; returns its result there and None elsewhere.  If it raises, rank
    0 re-raises and every other rank raises RuntimeError."""
    if mesh is None or mesh.group is None:
        return fn()
    result, error = None, None
    if mesh.is_main:
        try:
            result = fn()
        except Exception as e:   # reported to the other ranks, then re-raised
            error = e
    ok = torch.tensor([0 if error is not None else 1], dtype=torch.int32,
                      device=mesh.device)
    dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
    if error is not None:
        raise error
    if not int(ok.item()):
        raise RuntimeError("rank 0 failed; its error is in its output")
    return result


def barrier(mesh: Mesh) -> None:
    """Wait until every rank gets here (an all-reduce on the mesh's device,
    which both backends run)."""
    if mesh.group is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def check_replicas(mesh: Mesh, params, tag: str = "grids") -> str:
    """Raise RuntimeError unless every rank holds bit-equal ``params``;
    prints and returns this rank's digest of them (sha256, 16 hex)."""
    import hashlib
    h = hashlib.sha256()
    for x in params:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    hexd = h.hexdigest()[:16]
    print(f"[rank {mesh.rank}/{mesh.size}] {tag} sha256 {hexd}", flush=True)
    if mesh.group is not None:
        word = int(hexd[:15], 16)    # 60 bits, positive in int64
        lo = torch.tensor([word], dtype=torch.int64, device=mesh.device)
        hi = lo.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
        if int(lo.item()) != int(hi.item()):
            raise RuntimeError(f"{tag} differ between ranks")
    return hexd


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, nprocs: int, args: tuple = (), device=None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(mesh, *args)`` on ``nprocs`` ranks, one new process each
    (the ``spawn`` start method; ``fn`` and ``args`` are pickled), joined
    in one group at a free local port.  CPU ranks run torch on one thread.
    Returns when every rank has returned; raises when one fails, after
    stopping the others, and with ``timeout_s`` stops them all and raises
    TimeoutError when they have not returned by then."""
    import torch.multiprocessing as mp
    address = f"127.0.0.1:{_free_port()}"
    ctx = mp.start_processes(_rank_entry, args=(fn, nprocs, address,
                                                str(resolve_device(device)), args),
                             nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(None if deadline is None else max(deadline - time.monotonic(), 0.0)):
        if deadline is not None and time.monotonic() >= deadline:
            for p in ctx.processes:
                p.terminate()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{nprocs} rank(s) did not return within {timeout_s} s")


def _rank_entry(rank, fn, nprocs, address, device, args):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(address, nprocs, rank, device=device)
    try:
        mesh = make_mesh(nprocs, device=device)
        fn(mesh, *args)
        barrier(mesh)
    finally:
        dist.destroy_process_group()
