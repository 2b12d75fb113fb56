"""Host input pipeline (the JAX package's data/pipeline.py, without JAX).

`make_loader` yields numpy batches from a thread pool, deterministically
per (seed, epoch, index). `prefetch_to_device` wraps it: a background thread
turns each batch into torch tensors and pins them (on a CUDA device), and
the consumer copies them with `.to(device, non_blocking=True)` on its own
current stream. Images come out NCHW (a channels_last view of the NHWC
batch), labels NHW int64.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator

import numpy as np
import torch


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
    """Yields (images f32 NHWC, labels i32 NHW) numpy batches."""
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
                yield (np.stack(cols[0]).astype(np.float32),
                       np.stack(cols[1]).astype(np.int32))
            epoch += 1


def prefetch_to_device(iterator, device, *, buffer_size: int = 2):
    """Keep up to `buffer_size` host batches converted (and pinned) ahead of
    the consumer; copy each to `device` as it is taken. An exception in the
    producer is raised in the consumer."""
    device = torch.device(device)
    pin = device.type == "cuda"
    q: Queue = Queue(maxsize=buffer_size)
    done = object()
    failure = []

    def _producer():
        try:
            for images, labels in iterator:
                t = (torch.from_numpy(images), torch.from_numpy(labels))
                if pin:
                    t = tuple(a.pin_memory() for a in t)
                q.put(t)
        except Exception as e:  # re-raised in the consumer below
            failure.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=_producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is done:
            break
        images, labels = (a.to(device, non_blocking=True) for a in item)
        yield images.permute(0, 3, 1, 2), labels.long()
    thread.join()
    if failure:
        raise failure[0]
