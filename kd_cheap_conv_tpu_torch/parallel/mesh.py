"""The data-parallel layer on torch.distributed (the JAX package's
parallel/mesh.py).

The JAX package runs one SPMD program over a 1-D 'data' mesh: batches
sharded along it, parameters replicated, its `*_sharded` kernel wrappers
psum-ing the BN moments, the BN-backward sums and the loss sums. Here each
rank is a process with its own rows of the global batch, and the same
reductions are all-reduces between the passes of the port's wrappers:

- `init_distributed` starts the process group (from its arguments, or from
  torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT) and makes it
  the active group, the counterpart of the JAX package's
  `config.active_mesh()`;
- `shard_batch` gives rank r rows [r n/W, (r + 1) n/W) of every tensor of
  a batch, as the JAX `shard_batch` places them on the mesh;
- `replicate` broadcasts a module's parameters and buffers from rank 0;
- `all_reduce_sum`, `sync_moments`, `sync_sums` and `allreduce_grads` are
  the collectives the wrappers, the sync-BN and the train step call.

With no group, or a group of one rank, none of them calls a collective and
every wrapper takes exactly its single-process path.

The hazard they guard is silent: a train-mode BN or a loss mean left local
under a group does not fail, it trains another model (per-rank moments,
per-rank means), which only a comparison with the one-process run shows.
tests/test_torch_parallel.py holds every wrapper, the sync-BN and a whole KD
step against the one-process run; `chip_smoke.py` phase `ddp_parity` does
the same on the card at config #2's full width.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# A dead rank makes the others fail after this long instead of hanging. It
# covers rank 0's one-off teacher-logit cache build (the other ranks wait
# at a barrier meanwhile): 256 images at 513² take minutes, mostly zlib.
DEFAULT_TIMEOUT_S = 1800.0

_active = {"group": None}


def active_group():
    """The group the model's train-mode wrappers and BNs reduce over (None:
    single process)."""
    return _active["group"]


def set_active_group(group) -> None:
    _active["group"] = group


def world_size(group=None) -> int:
    """Ranks in `group` (1 for None or without an initialised default
    group)."""
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group=None) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def sharded(group) -> bool:
    """True when `group` spans more than one rank: the wrappers then call
    their collectives."""
    return world_size(group) > 1


def sharded_group():
    """The active group when it spans more than one rank, else None: what
    the model's train-mode dispatch hands the `*_sharded` wrappers. Every
    rank holds its own rows of the batch (shard_batch refuses a batch that
    does not divide), so the JAX `_use_sharded` divisibility test has no
    counterpart here."""
    group = active_group()
    return group if sharded(group) else None


def choose_backend(device: torch.device, local_processes: int) -> str:
    """NCCL where each rank has a card of its own; gloo on the CPU and where
    ranks share a card (NCCL refuses two ranks on one device; gloo reduces
    CUDA tensors through the host)."""
    if (device.type == "cuda"
            and local_processes <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: torch.device | str = "cpu",
                     timeout_s: float = DEFAULT_TIMEOUT_S,
                     store=None):
    """Join the process group and make it the active group; returns it.

    coordinator_address "host:port" (the JAX flag's form; "tcp://host:port"
    too) of rank 0, the number of processes and this one's id; a missing
    value comes from torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE and
    RANK. `store` (a torch.distributed Store, e.g. a FileStore) replaces
    the address. The backend follows `choose_backend` (LOCAL_WORLD_SIZE,
    else all the processes, counted as this host's); it is printed."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside [0, "
                         f"{num_processes})")
    device = torch.device(device)
    local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = choose_backend(device, local)
    kw = {"store": store} if store is not None else {
        "init_method": _init_method(coordinator_address)}
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(
        backend, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    print(f"distributed: rank {process_id} of {num_processes}, backend "
          f"{backend}, device {device}", flush=True)
    group = dist.group.WORLD
    set_active_group(group)
    return group


def _init_method(address):
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def shutdown() -> None:
    """Leave the process group (if any) and clear the active group."""
    set_active_group(None)
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch, group):
    """This rank's rows [r n/W, (r + 1) n/W) of every array or tensor of a
    batch (a tuple), as the JAX shard_batch places a global batch on the
    mesh. A batch whose rows do not divide by W raises: every rank must
    hold the same number of rows, so that the counts the wrappers scale by
    are n_local * W."""
    w = world_size(group)
    if w == 1:
        return batch
    r = rank(group)

    def _rows(a):
        n = a.shape[0]
        if n % w:
            raise ValueError(f"batch of {n} rows does not divide over {w} "
                             f"ranks")
        k = n // w
        return a[r * k:(r + 1) * k]

    return tuple(_rows(a) for a in batch)


def replicate(module: torch.nn.Module, group) -> torch.nn.Module:
    """Broadcast `module`'s parameters and buffers from rank 0 (the JAX
    replicate); returns the module."""
    if sharded(group):
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in (*module.parameters(), *module.buffers()):
                dist.broadcast(t.data, src, group=group)
    return module


def barrier(group) -> None:
    if sharded(group):
        dist.barrier(group=group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """SUM-all-reduce t in place over `group` and return it; no call for a
    group of one rank. Counts its calls and bytes (`calls`, `bytes`), the
    collectives a step makes. A failed collective raises."""
    if not sharded(group):
        return t
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += t.numel() * t.element_size()
    return t


all_reduce_sum.calls = all_reduce_sum.bytes = 0


def global_count(count: float, group) -> float:
    """A local element count as the global one: every rank holds the same
    number of rows (shard_batch)."""
    return count * world_size(group)


def sync_sums(sums: torch.Tensor, group) -> torch.Tensor:
    """Global [sum g, sum g xhat] (or any sums) from this rank's: one
    all-reduce of a fresh copy (the local sums stay the local parameter
    gradients)."""
    if not sharded(group):
        return sums
    return all_reduce_sum(sums.clone(), group)


def sync_moments(mean: torch.Tensor, var: torch.Tensor, count: float,
                 group):
    """Global (mean, biased var) from this rank's moments over `count`
    elements a channel: the sums [n mean, n (var + mean^2)] as one (2, C)
    tensor in the moments' dtype, all-reduced, then mean = S / N,
    var = S2 / N - mean^2 (the E[x^2] - E[x]^2 form of the JAX psum path,
    stem.py:580-585, and of ops/stem.py `_moments`). Returns (mean, var)
    unchanged for a group of one rank.

    A train-mode BN whose moments stay local under a group is a silent
    divergence, not an error: tests/test_torch_parallel.py
    `test_wrapper_matches_jax_sharded` (every chain's moments) and
    `test_batchnorm_uses_global_moments` (the module-path BN) guard it."""
    if not sharded(group):
        return mean, var
    s = torch.stack([mean * count, (var + mean * mean) * count])
    all_reduce_sum(s, group)
    n = global_count(count, group)
    m = s[0] / n
    return m, s[1] / n - m * m


def allreduce_grads(params, group) -> None:
    """SUM the gradients of `params` over `group` in one flat all-reduce (a
    buffer per dtype and device). The loss each rank differentiates is the
    global one, so its gradients are its share of the global gradient and
    their sum is the gradient: an average would be W times too small."""
    if not sharded(group):
        return
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.dtype, p.grad.device), []).append(p)
    for ps in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        all_reduce_sum(flat, group)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
