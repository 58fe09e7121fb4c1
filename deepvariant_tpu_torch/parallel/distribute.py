"""Scale-out primitives on torch.distributed.

Counterpart of `deepvariant_tpu/parallel/distribute.py`, with the same
names. One process per card: NCCL between cards, gloo on the CPU (and
between processes that share a card).

  * `jax.distributed` -> `initialize_multihost`: a process group from
    explicit arguments or from the variables `torchrun` sets;
  * per-host region assignment -> `host_shard_assignment` (the
    reference's `i % num_shards == task_id` rule);
  * the data-axis `Mesh` and its `NamedSharding`s -> `DataParallel`:
    this rank's place in the group, its device, and the rows of a
    global batch that it holds (`data_parallel_mesh` and `shardings`
    return it, so a reader finds the counterpart);
  * the all-gather over the data axis -> `all_gather_counts`, one count
    per rank over the group;
  * the host-side double-buffered device prefetch ->
    `DevicePrefetchIterator` (pinned buffers and a side stream, through
    `calling.call_variants.BatchStager`) and `fused_encode_infer`.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import os
import queue
import threading
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist

from deepvariant_tpu_torch.calling.call_variants import (BatchStager,
                                                         PendingResult)
from deepvariant_tpu_torch.device import resolve_device

# A missing peer makes every collective fail after this long.
DEFAULT_TIMEOUT_S = 600.0

_log = logging.getLogger(__name__)


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when the ranks compute on CUDA and each rank of this host has
    a card of its own; gloo otherwise (the CPU, or ranks sharing a
    card, which NCCL refuses)."""
    if device.type == "cuda" and \
            local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Tuple[int, int]:
    """Join the process group if there is one; returns (rank, world size).

    With `num_processes > 1` the group meets at `coordinator_address`
    (`host:port`, or a URL such as `file:///path/store`). With no
    arguments it reads the variables `torchrun` sets (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE), as
    `jax.distributed.initialize()` reads its cluster's; without them
    this is one process and no group is made. A rank on CUDA takes card
    LOCAL_RANK (modulo the cards of its host). A group that fails to
    form raises: nothing switches backend on failure."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address "
                             "and process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    elif num_processes is None and "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    else:
        return 0, 1
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    device = resolve_device(device)
    backend = choose_backend(device, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    _log.info("rank %d of %d joined the %s group", rank, world, backend)
    return rank, world


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_shard_assignment(
    num_items: int,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[int]:
    """Round-robin item indices for this host (the reference's
    `i % num_shards == task_id` rule, make_examples_core.py:881), from
    the group's rank and size when the arguments are omitted."""
    grouped = dist.is_initialized()
    pid = (dist.get_rank() if grouped else 0) if process_id is None \
        else process_id
    n = (dist.get_world_size() if grouped else 1) if process_count is None \
        else process_count
    return [i for i in range(num_items) if i % n == pid]


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in a data-parallel group: the counterpart of
    a one-axis `data` mesh. The state is replicated on every rank; a
    global batch is cut into the rows each rank holds (`local_rows`).
    `backend` is None when there is no process group (one process)."""

    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None

    @property
    def grouped(self) -> bool:
        return self.backend is not None

    @property
    def collective_device(self) -> torch.device:
        """Where the group's own small tensors live: the card for NCCL,
        the host for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")

    def local_rows(self, batch_size: int, accum: int = 1) -> np.ndarray:
        """This rank's rows of a global batch of `batch_size` split into
        `accum` micro batches: micro batch k is the global rows
        [k*B/accum, (k+1)*B/accum), cut contiguously over the ranks (as
        JAX's reshape of a data-sharded batch to (accum, B/accum) lays
        it out), so a rank holds, for each k in turn, its contiguous part
        of micro batch k, and its own batch splits into its `accum`
        micro batches contiguously."""
        if batch_size % (accum * self.world_size):
            raise ValueError(
                f"batch {batch_size} does not split into {accum} micro "
                f"batches over {self.world_size} ranks")
        micro = batch_size // accum
        part = micro // self.world_size
        rows = (np.arange(accum)[:, None] * micro + self.rank * part
                + np.arange(part)[None, :])
        return rows.reshape(-1)

    def local_batch(self, batch: Dict[str, np.ndarray],
                    accum: int = 1) -> Dict[str, np.ndarray]:
        """This rank's rows of every array of a global batch (the batch
        itself on one rank)."""
        if self.world_size == 1:
            return batch
        size = len(next(iter(batch.values())))
        rows = self.local_rows(size, accum)
        return {k: v[rows] for k, v in batch.items()}

    def all_reduce_sum(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum `tensor` over the ranks, in place; returns it. gloo's CUDA
        collectives are not used: a CUDA tensor under gloo is copied
        through pinned host memory explicitly, reduced there and copied
        back."""
        if not self.grouped:
            return tensor
        if tensor.is_cuda and self.backend != "nccl":
            host = torch.empty(tensor.shape, dtype=tensor.dtype,
                               pin_memory=True)
            host.copy_(tensor)
            dist.all_reduce(host)
            tensor.copy_(host)
        else:
            dist.all_reduce(tensor)
        return tensor

    def gather_over_ranks(self, tensor: torch.Tensor) -> torch.Tensor:
        """Every rank's `tensor` stacked in rank order, (world_size,
        *shape), by one all-reduce of a zero-padded stack, which autograd
        differentiates: the gradient of a sum over the ranks is the sum
        over the ranks of the incoming gradients."""
        rows = [tensor if r == self.rank else torch.zeros_like(tensor)
                for r in range(self.world_size)]
        return _SumOverRanks.apply(torch.stack(rows), self)

    def barrier(self) -> None:
        if self.grouped:
            dist.barrier()


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, data_parallel):
        ctx.data_parallel = data_parallel
        return data_parallel.all_reduce_sum(tensor.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.data_parallel.all_reduce_sum(grad.clone()), None


def data_parallel_mesh(
    device: Union[str, torch.device] = "cuda",
) -> DataParallel:
    """The data-parallel description of this process: the group's size,
    rank and backend when there is a group, else one rank. `device` is
    where this rank computes; "cuda" without an index is the card the
    rank took at `initialize_multihost`."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return DataParallel(device=device)
    return DataParallel(dist.get_world_size(), dist.get_rank(), device,
                        dist.get_backend())


def shardings(mesh: DataParallel):
    """(replicated, data_sharded) as functions: the state stays as it is
    on every rank, and a global batch becomes this rank's rows."""
    return (lambda state: state), mesh.local_batch


def all_gather_counts(
    local_counts: Union[int, Sequence[int]],
    mesh: Optional[DataParallel] = None,
) -> np.ndarray:
    """All-gather one count per rank over the group; every rank receives
    the (world_size,) vector. A rank holds one mesh position, so it
    passes one count (an int or a sequence of one)."""
    mesh = mesh or data_parallel_mesh()
    counts = np.asarray(local_counts, np.int64).reshape(-1)
    if counts.shape != (1,):
        raise ValueError(
            f"need one count per mesh position: got {counts.shape}, this "
            "rank holds 1 mesh position")
    if not mesh.grouped:
        return counts
    local = torch.from_numpy(counts).to(mesh.collective_device)
    gathered = torch.empty(mesh.world_size, dtype=torch.int64,
                           device=mesh.collective_device)
    dist.all_gather_into_tensor(gathered, local)
    return gathered.cpu().numpy()


def _stage_parts(item) -> Dict[str, List[np.ndarray]]:
    if isinstance(item, dict):
        return {k: list(np.asarray(v)) for k, v in item.items()}
    return {"": list(np.asarray(item))}


class DevicePrefetchIterator:
    """Double-buffered host-to-device pipeline.

    A background thread pulls host batches (arrays, or dicts of arrays)
    from `source`, stacks each into a pinned buffer and copies it to
    `device` on a side stream (`BatchStager`'s slots); the consumer's
    stream waits for the copy. Order is kept; an error in the source
    surfaces on `next()`. On the CPU it only moves tensors."""

    def __init__(self, source: Iterable,
                 device: Union[str, torch.device] = "cuda",
                 buffer_size: int = 2):
        device = resolve_device(device)
        # A slot is refilled only once its copy is done: the queue's
        # items, the one being consumed and the one being filled.
        stager = BatchStager(device, slots=buffer_size + 2)
        self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._done = object()
        self._error: Optional[BaseException] = None

        def worker():
            if device.index is not None:
                torch.cuda.set_device(device)
            try:
                for item in source:
                    staged = stager.stage(_stage_parts(item))
                    self._queue.put(staged if isinstance(item, dict)
                                    else staged[""])
            except BaseException as e:  # surfaced on next()
                self._error = e
            finally:
                self._queue.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._done:
            self._thread.join()
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def fused_encode_infer(
    example_batches: Iterable[np.ndarray],
    forward: Callable,
    variables,
    device: Union[str, torch.device] = "cuda",
    prefetch: int = 2,
) -> Iterator[np.ndarray]:
    """Pipeline host encoding against device inference.

    `example_batches` yields fixed-shape uint8 (B, H, W, C) batches
    (host encode); `forward(variables, batch)` runs the model on the
    device. Batches prefetch to the device while it runs the previous
    one; at most `prefetch` forwards are in flight, and results come
    back in order through pinned buffers."""
    device_iter = DevicePrefetchIterator(example_batches, device,
                                         buffer_size=prefetch)
    inflight: collections.deque = collections.deque()
    for batch in device_iter:
        inflight.append(PendingResult(forward(variables, batch)))
        while len(inflight) > prefetch:
            yield inflight.popleft().numpy()
    while inflight:
        yield inflight.popleft().numpy()
