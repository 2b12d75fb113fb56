"""Host input pipeline (the JAX package's data/pipeline.py, without JAX).

`make_loader` yields numpy batches from a thread pool, deterministically
per (seed, epoch, index). `prefetch_to_device` wraps it: a background thread
turns each batch into torch tensors and pins them (on a CUDA device), and
the consumer copies them with `.to(device, non_blocking=True)` on its own
current stream. Images come out NCHW (a channels_last view of the NHWC
batch), labels NHW int64, and a cached-teacher batch's logits as they
were loaded (NHWC, float16). Under a group of more than one rank each rank
keeps its rows of every global batch (`shard_batch`) before the copy, so W
ranks and one process with the same seed see the same images.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator

import numpy as np
import torch

from ..parallel.mesh import shard_batch


def make_loader(
    dataset,
    *,
    batch_size: int,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    num_workers: int = 8,
    num_epochs: int | None = None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields (images f32 NHWC, labels i32 NHW) numpy batches, and the
    cached-teacher logits (N, H, W, C) in their stored dtype where the
    dataset yields them."""
    n = len(dataset)
    epoch = 0
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        while num_epochs is None or epoch < num_epochs:
            order = np.arange(n)
            if shuffle:
                np.random.default_rng((seed, epoch)).shuffle(order)
            for start in range(0, n, batch_size):
                idxs = order[start:start + batch_size]
                if len(idxs) < batch_size and drop_last:
                    break

                def _get(i, epoch=epoch):
                    rng = np.random.default_rng((seed, epoch, int(i)))
                    return dataset.__getitem__(int(i), rng)

                cols = list(zip(*pool.map(_get, idxs)))
                # a cached-teacher sample's logits keep their dtype
                yield (np.stack(cols[0]).astype(np.float32),
                       np.stack(cols[1]).astype(np.int32),
                       *(np.stack(c) for c in cols[2:]))
            epoch += 1


def prefetch_to_device(iterator, device, *, buffer_size: int = 2,
                       group=None):
    """Keep up to `buffer_size` host batches converted (and pinned) ahead of
    the consumer; copy each to `device` as it is taken. With a `group` of
    more than one rank only this rank's rows of each batch (images, labels,
    cached teacher logits) are converted and copied; a batch that does not
    divide raises. An exception in the producer is raised in the consumer.
    Closing the generator early (an endless train loader at the end of
    training) stops the producer after its current batch and joins it."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: Queue = Queue(maxsize=buffer_size)
    done = object()
    stop = threading.Event()
    failure = []

    def _producer():
        try:
            for batch in iterator:
                if stop.is_set():
                    break
                t = tuple(torch.from_numpy(a)
                          for a in shard_batch(batch, group))
                if pin:
                    t = tuple(a.pin_memory() for a in t)
                q.put(t)
        except Exception as e:  # re-raised in the consumer below
            failure.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    item = None
    try:
        while True:
            item = q.get()
            if item is done:
                break
            images, labels, *extra = (a.to(device, non_blocking=True)
                                      for a in item)
            yield (images.permute(0, 3, 1, 2), labels.long(), *extra)
    finally:
        stop.set()
        while item is not done:     # unblock a producer waiting to put
            item = q.get()
        thread.join()
    if failure:
        raise failure[0]
