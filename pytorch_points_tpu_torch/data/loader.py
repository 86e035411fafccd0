"""Datasets and bucketed batching (counterpart of the JAX
``data/loader.py``; host-side numpy).

The batches stay numpy arrays, as the reference's do; the caller moves
them to the device (``torch.from_numpy(...).to(device)``), best inside the
iterable a :class:`Prefetcher` runs, so the copy overlaps the step.
"""

from __future__ import annotations

import os
import queue
import threading
from collections.abc import Callable, Iterator, Sequence

import numpy as np

from pytorch_points_tpu_torch.core.masking import bucket_sizes
from pytorch_points_tpu_torch.utils import pc_utils


class PlyFolderDataset:
    """All .ply clouds under a directory.

    Args:
      root: directory scanned recursively for ``*.ply``.
      transform: optional fn(xyz [N,3] f32) -> xyz applied per cloud.
      normalize: center + unit-sphere scale each cloud.
    """

    def __init__(self, root: str, *, transform: Callable | None = None,
                 normalize: bool = True):
        self.files = sorted(
            os.path.join(d, f)
            for d, _, fs in os.walk(root)
            for f in fs
            if f.endswith(".ply")
        )
        if not self.files:
            raise FileNotFoundError(f"no .ply files under {root}")
        self.transform = transform
        self.normalize = normalize

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> np.ndarray:
        xyz = pc_utils.read_ply(self.files[i])
        if self.normalize:
            xyz, _, _ = pc_utils.normalize_point_cloud(xyz)
        if self.transform is not None:
            xyz = self.transform(xyz)
        return np.asarray(xyz, np.float32)


def random_clouds(count: int, lo: int = 512, hi: int = 4096, seed: int = 0):
    """Synthetic variable-size dataset (list of [N_i, 3] arrays)."""
    rng = np.random.default_rng(seed)
    return [
        rng.uniform(-1, 1, (int(n), 3)).astype(np.float32)
        for n in rng.integers(lo, hi + 1, size=count)
    ]


class BucketedBatcher:
    """Group variable-size clouds into padded static-shape batches.

    Each yielded batch is ``{"points": [B, bucket, 3] f32,
    "mask": [B, bucket] bool}`` with every cloud padded to its bucket
    size: at most ``max_buckets`` distinct shapes reach the model, and the
    ops' mask arguments keep the padding out of every result. The same
    ``seed`` gives the reference's order; it advances by one each
    shuffled epoch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        multiple: int = 256,
        max_buckets: int = 4,
        shuffle: bool = True,
        drop_remainder: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        sizes = [self._size(i) for i in range(len(dataset))]
        self.buckets = bucket_sizes(
            sizes, multiple=multiple, max_buckets=max_buckets
        )
        self._bucket_of = np.array(
            [min(b for b in self.buckets if b >= s) for s in sizes]
        )

    def _size(self, i: int) -> int:
        item = self.dataset[i]
        return item.shape[0]

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
            self.seed += 1
        # group indices per bucket, emit full batches per bucket
        pending: dict[int, list[int]] = {b: [] for b in self.buckets}
        for i in order:
            b = int(self._bucket_of[i])
            pending[b].append(int(i))
            if len(pending[b]) == self.batch_size:
                yield self._emit(pending[b], b)
                pending[b] = []
        if not self.drop_remainder:
            for b, idxs in pending.items():
                if idxs:
                    yield self._emit(idxs, b)

    def _emit(self, idxs: Sequence[int], bucket: int) -> dict:
        pts = np.zeros((len(idxs), bucket, 3), np.float32)
        mask = np.zeros((len(idxs), bucket), bool)
        for row, i in enumerate(idxs):
            xyz = self.dataset[i]
            n = xyz.shape[0]
            pts[row, :n] = xyz
            mask[row, :n] = True
        return {"points": pts, "mask": mask}


class Prefetcher:
    """Background-thread batch prefetch: host file I/O, padding and the
    copy to the device overlap the device's compute.

    Wraps any batch iterable (e.g. :class:`BucketedBatcher`).  A daemon
    thread keeps up to ``depth`` ready batches in a queue; iterating
    yields them in order.  Exceptions in the producer re-raise at the
    consumer.  Re-iterable: each ``iter()`` starts a fresh pass.

        for batch in Prefetcher(batcher, depth=2):
            loss = step(batch)
    """

    _DONE = object()

    def __init__(self, batches, depth: int = 2):
        self.batches = batches
        self.depth = depth

    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            # Bounded put that aborts when the consumer abandons the
            # iteration (break/exception/GC-close) — otherwise the
            # producer would block forever on a full queue and leak one
            # pinned thread (plus its in-flight batches) per partial pass.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self.batches:
                    if not put(b):
                        return
            except BaseException as e:  # re-raised at the consumer
                put(e)
                return
            put(self._DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
