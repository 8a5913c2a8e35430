"""Host-side batch iterators and the copy to the device.

Twin of ``apex_tpu/data/loaders.py``: endless synthetic NHWC uint8
batches, ``.npz`` shards, torchvision-style image folders decoded by a
PIL thread pool with the reference's train and eval transforms
(:func:`image_folder_loader`), the host-side space-to-depth layout for
``ResNet(stem="s2d_pre")``, and :func:`prefetch_to_device`, which
stages the next batches onto the card from a background thread (pinned
host memory, a copy on a side CUDA stream, an event the consuming
stream waits on), so the copy overlaps the step that runs.

Not here yet: the native JPEG decoder and the native gather.
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


IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _list_image_folder(root: str):
    """``(samples, classes)`` of torchvision's ImageFolder layout,
    ``root/<class>/<image>``: classes sorted, labels their positions,
    images sorted within each class."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    samples = []
    for label, cls in enumerate(classes):
        for path in sorted(glob.glob(os.path.join(root, cls, "*"))):
            if path.lower().endswith(IMAGE_EXTENSIONS):
                samples.append((path, label))
    if not samples:
        raise FileNotFoundError(f"no images under {root}")
    return samples, classes


def _decode_train(path: str, image_size: int, rng: np.random.RandomState):
    """The reference's training transform: RandomResizedCrop (area
    0.08-1.0, aspect 3/4-4/3, ten tries, then a centre crop of the short
    side) to ``image_size``, bilinear, then a horizontal flip with
    probability 1/2; every draw from ``rng``."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        area = w * h
        for _ in range(10):
            target = area * rng.uniform(0.08, 1.0)
            ar = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                x0 = rng.randint(0, w - cw + 1)
                y0 = rng.randint(0, h - ch + 1)
                im = im.resize((image_size, image_size), Image.BILINEAR,
                               box=(x0, y0, x0 + cw, y0 + ch))
                break
        else:
            s = min(w, h)
            x0, y0 = (w - s) // 2, (h - s) // 2
            im = im.resize((image_size, image_size), Image.BILINEAR,
                           box=(x0, y0, x0 + s, y0 + s))
        arr = np.asarray(im, np.uint8)
    if rng.rand() < 0.5:
        arr = arr[:, ::-1]
    return arr


def _decode_eval(path: str, image_size: int):
    """The reference's validation transform: the short side resized to
    ``image_size * 256 / 224``, bilinear, then the centre
    ``image_size`` square."""
    from PIL import Image

    resize = int(image_size * 256 / 224)
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        im = im.resize((nw, nh), Image.BILINEAR)
        x0, y0 = (nw - image_size) // 2, (nh - image_size) // 2
        im = im.crop((x0, y0, x0 + image_size, y0 + image_size))
        return np.asarray(im, np.uint8)


def image_folder_loader(root: str, batch_size: int, image_size: int = 224,
                        train: bool = True, shuffle: Optional[bool] = None,
                        seed: int = 0, num_workers: int = 8,
                        loop: bool = True, samples=None,
                        native: bool = True, num_shards: int = 1,
                        shard_index: int = 0):
    """``(x uint8 NHWC, y int32)`` batches from a torchvision-style image
    folder, decoded by a pool of ``num_workers`` threads with PIL:
    RandomResizedCrop and a flip for ``train``, Resize and CenterCrop
    otherwise.  The port has no native JPEG decoder yet, so ``native``
    changes nothing: every file takes the PIL pool, as the JAX package
    does when its decoder is missing (``native=False`` there).

    ``shuffle`` defaults to ``train``.  ``loop=False`` gives one pass
    with a short last batch; a training epoch drops its short tail.
    ``samples`` (from :func:`_list_image_folder`) skips listing ``root``
    again.  ``num_shards``/``shard_index``: every shard draws the same
    permutation each epoch and takes its strided slice of it, the
    remainder of fewer than ``num_shards`` samples dropped (the
    ``DistributedSampler`` role); ``batch_size`` is this shard's.  The
    augmentation seeds of an epoch come from an RNG of their own per
    (epoch, shard), drawn in the calling thread."""
    del native
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in "
                         f"[0, {num_shards})")
    if samples is None:
        samples, _ = _list_image_folder(root)
    if train and len(samples) // num_shards < batch_size:
        raise ValueError(
            f"{root}: {len(samples)} images / {num_shards} shards < "
            f"batch_size {batch_size}; a training epoch would produce "
            "zero batches")
    if shuffle is None:
        shuffle = train
    return _image_folder_iter(samples, batch_size, image_size, train,
                              shuffle, seed, num_workers, loop, num_shards,
                              shard_index)


def _image_folder_iter(samples, batch_size, image_size, train, shuffle,
                       seed, num_workers, loop, num_shards=1, shard_index=0):
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.RandomState(seed)

    def decode(item):
        (path, label), item_seed = item
        if train:
            # the seed was drawn in the calling thread: a RandomState is
            # not shared between threads
            return _decode_train(path, image_size,
                                 np.random.RandomState(item_seed)), label
        return _decode_eval(path, image_size), label

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        epoch = 0
        while True:
            order = rng.permutation(len(samples)) if shuffle \
                else np.arange(len(samples))
            if num_shards > 1:
                usable = (len(order) // num_shards) * num_shards
                order = order[:usable][shard_index::num_shards]
            aug_rng = np.random.RandomState(
                (seed * 1000003 + epoch * 9973 + shard_index) % (2 ** 31))
            for i in range(0, len(order), batch_size):
                idx = order[i:i + batch_size]
                if train and len(idx) < batch_size:
                    break
                seeds = aug_rng.randint(2 ** 31, size=len(idx))
                decoded = list(pool.map(decode, [
                    (samples[j], s) for j, s in zip(idx, seeds)]))
                yield (np.stack([d[0] for d in decoded]).astype(np.uint8),
                       np.asarray([d[1] for d in decoded], np.int32))
            epoch += 1
            if not loop:
                return


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
