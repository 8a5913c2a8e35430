"""Host-side batch iterators and the copy to the device.

Twin of ``apex_tpu/data/loaders.py``: endless synthetic NHWC uint8
batches, ``.npz`` shards, the host-side space-to-depth layout for
``ResNet(stem="s2d_pre")``, and :func:`prefetch_to_device`, which
stages the next batches onto the card from a background thread (pinned
host memory, a copy on a side CUDA stream, an event the consuming
stream waits on), so the copy overlaps the step that runs.

Not here yet: the ImageFolder loader (decoded JPEGs with the
reference's train and eval transforms) and the native gather.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch._device import resolve_device


def synthetic_loader(batch_size: int, image_size: int = 224,
                     num_classes: int = 1000,
                     seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless random NHWC uint8 RGB images and int32 labels from
    ``np.random.RandomState(seed)`` (the JAX package's bytes)."""
    rng = np.random.RandomState(seed)
    shape = (batch_size, image_size, image_size, 3)
    while True:
        x = rng.randint(0, 256, shape, dtype=np.uint8)
        y = rng.randint(0, num_classes, (batch_size,), dtype=np.int32)
        yield x, y


def npz_loader(data_dir: str, batch_size: int, seed: int = 0,
               num_shards: int = 1,
               shard_index: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless batches from the ``.npz`` shards of ``data_dir``, each
    holding ``x`` (N, H, W, C uint8) and ``y`` (N int), shards and rows
    shuffled.  Every rank draws the same permutations from ``seed`` and
    takes the rows
    ``shard_index::num_shards`` of each (the ``DistributedSampler``
    role)."""
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in "
                         f"[0, {num_shards})")
    shards = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if not shards:
        raise FileNotFoundError(f"no .npz shards in {data_dir}")
    rng = np.random.RandomState(seed)
    while True:
        for si in rng.permutation(len(shards)):
            with np.load(shards[si]) as z:
                x, y = z["x"], z["y"]
            n = x.shape[0]
            perm = rng.permutation(n)
            if num_shards > 1:
                usable = (n // num_shards) * num_shards
                perm = perm[:usable][shard_index::num_shards]
            if len(perm) < batch_size:
                raise ValueError(
                    f"{shards[si]}: {n} rows / {num_shards} shards < "
                    f"batch_size {batch_size}; this shard cannot produce "
                    "a single batch")
            for i in range(len(perm) // batch_size):
                idx = perm[i * batch_size:(i + 1) * batch_size]
                yield x[idx], y[idx]


def s2d_batches(iterator):
    """``(x, y)`` batches with x moved to ``ResNet(stem="s2d_pre")``'s
    input layout on the host (``models.resnet.s2d_input_transform``)."""
    from apex_tpu_torch.models.resnet import s2d_input_transform
    for x, y in iterator:
        yield s2d_input_transform(np.asarray(x)), y


def _stage(batch, device: torch.device, stream):
    """The arrays of ``batch`` as tensors on ``device``; on the card,
    copied from pinned memory on ``stream``, with the event that marks
    the copies' end."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
    if stream is None:
        return tuple(t.to(device) for t in tensors), None
    with torch.cuda.stream(stream):
        out = tuple(t.pin_memory().to(device, non_blocking=True)
                    for t in tensors)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


PREFETCH = 2      # batches staged ahead of the step, as the JAX package


def prefetch_to_device(iterator, device="cuda"):
    """Yield the batches of ``iterator`` (tuples of arrays) as tensors on
    ``device``, staged by a background thread up to ``PREFETCH`` batches
    ahead.  On the card each batch is copied from pinned host memory on a
    side stream; before a batch is handed over, the current stream waits
    for its copy (no host sync) and its tensors are recorded on that
    stream for the allocator.  A loader's exception reaches the
    consumer.  Returns a generator; closing it stops the thread."""
    dev = resolve_device(device)
    stream = None
    if dev.type == "cuda":
        if dev.index is None:      # the caller's current card, by number
            dev = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(dev)
    return _prefetch(iterator, dev, stream)


def _prefetch(iterator, dev: torch.device, stream):
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        try:
            for batch in iterator:
                if not put(_stage(batch, dev, stream)):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised by the consumer
            put(e)
        else:
            put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            tensors, done = item
            if done is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(done)
                for t in tensors:
                    t.record_stream(current)
            yield tensors
    finally:
        stop.set()
        thread.join(timeout=5.0)
