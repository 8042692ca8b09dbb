"""Host input pipeline: prepared-KITTI dataset + threaded prefetching loader.

The port's own copy of the JAX package's ``data/loader.py``: the same sample
stream, bit for bit (tests/test_torch_data.py). It replaces the reference's
torch DataLoader (the reference's train.py:125) with a dependency-free numpy
pipeline: worker threads decode/resize samples (cv2 releases the GIL in
imdecode/resize), batches are assembled NHWC and staged ahead of the train
step so the device never waits on the host.

Sample semantics mirror core/dataset/kitti_prepared.py:
- stacked [3H, W, 3] PNG split into thirds, each resized to img_hw
- whole-stack horizontal flip with p=0.5
- /255.0; intrinsics read from the *last line* of the calib file, rescaled to
  img_hw, expanded into a per-scale pyramid with inverses
- virtual epoch length: index i draws sample RandomState(i).randint(N)
  (kitti_prepared.py:38-48), making the stream deterministic per index.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def read_cam_intrinsic(fname: str) -> np.ndarray:
    """Intrinsics from the last line of a KITTI calib file
    (kitti_prepared.py:101-108)."""
    with open(fname) as f:
        lines = f.readlines()
    data = lines[-1].strip("\n").split(" ")[1:]
    mat = np.array([float(k) for k in data]).reshape(3, 4)
    return mat[:3, :3]


def rescale_intrinsics(K: np.ndarray, hw_orig, hw_new) -> np.ndarray:
    K = K.copy()
    K[0, :] *= hw_new[1] / hw_orig[1]
    K[1, :] *= hw_new[0] / hw_orig[0]
    return K


def multiscale_intrinsics(K: np.ndarray, num_scales: int):
    """Per-scale K pyramid + inverses (kitti_prepared.py:115-130)."""
    K_ms, K_inv_ms = [], []
    for s in range(num_scales):
        K_new = K.copy()
        K_new[0, :] /= 2**s
        K_new[1, :] /= 2**s
        K_ms.append(K_new)
        K_inv_ms.append(np.linalg.inv(K_new))
    return np.stack(K_ms).astype(np.float32), np.stack(K_inv_ms).astype(np.float32)


class KittiPreparedDataset:
    """Reads prepared 3-frame stacks listed in ``<data_dir>/train.txt``."""

    def __init__(
        self,
        data_dir: str,
        num_scales: int = 3,
        img_hw=(256, 832),
        num_iterations: int | None = None,
        seed: int = 0,
        cache_decoded_bytes: int = 0,
        uint8_images: bool = False,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        """``shard_id``/``num_shards``: multi-host data parallelism -- each
        process owns the [shard_id::num_shards] stride of train.txt (and a
        shard-distinct resampling seed), so hosts never read each other's
        files. Single-host runs keep the identity shard."""
        self.uint8_images = uint8_images
        self.data_dir = data_dir
        self.num_scales = num_scales
        self.img_hw = tuple(img_hw)
        self.num_iterations = num_iterations
        self.seed = seed + 1000003 * shard_id
        self.data_list = self._read_index(os.path.join(data_dir, "train.txt"))
        if num_shards > 1:
            self.data_list = self.data_list[shard_id::num_shards]
            if not self.data_list:
                raise ValueError(
                    f"shard {shard_id}/{num_shards} of {data_dir} is empty"
                )
        # optional decoded-PNG cache: on a weak host the cv2.imread of the
        # stacked PNG can dominate step time on a weak host; caching the decode (NOT the augmentation --
        # per-index resampling/flip stays downstream) removes it for datasets
        # that fit the byte budget. 0 disables.
        self._cache_budget = cache_decoded_bytes
        self._cache_used = 0
        self._decode_cache: dict = {}

    def _read_index(self, info_file):
        with open(info_file) as f:
            lines = f.readlines()
        out = []
        for line in lines:
            parts = line.strip().split()
            if len(parts) < 2:
                continue
            out.append(
                {
                    "image_file": os.path.join(self.data_dir, parts[0]),
                    "cam_intrinsic_file": os.path.join(self.data_dir, parts[1]),
                }
            )
        return out

    def count(self) -> int:
        return len(self.data_list)

    def __len__(self) -> int:
        return self.num_iterations if self.num_iterations is not None else self.count()

    def __getitem__(self, idx: int):
        rng = np.random.RandomState(self.seed + idx)
        if self.num_iterations is not None:
            idx = rng.randint(self.count())
        data = self.data_list[idx]
        cached = self._decode_cache.get(data["image_file"])
        if cached is None:
            raw = cv2.imread(data["image_file"])
            h_orig = raw.shape[0] // 3
            hw_orig = (h_orig, raw.shape[1])
            h, w = self.img_hw
            parts = [
                cv2.resize(raw[i * h_orig : (i + 1) * h_orig], (w, h))
                for i in range(3)
            ]
            img = np.concatenate(parts, axis=0)
            cached = (img, hw_orig)
            if self._cache_budget and self._cache_used + img.nbytes <= self._cache_budget:
                self._decode_cache[data["image_file"]] = cached
                self._cache_used += img.nbytes
        img, hw_orig = cached
        if rng.rand() > 0.5:
            img = img[:, ::-1]
        if self.uint8_images:
            # ship uint8; the step normalizes on the device (split_stack);
            # the transfer is 4x smaller than f32
            img = np.ascontiguousarray(img)
        else:
            img = (img / 255.0).astype(np.float32)

        K = read_cam_intrinsic(data["cam_intrinsic_file"])
        K = rescale_intrinsics(K, hw_orig, self.img_hw)
        K_ms, K_inv_ms = multiscale_intrinsics(K, self.num_scales)
        return img, K_ms, K_inv_ms


class BatchLoader:
    """Threaded prefetching batch iterator over an indexable dataset.

    Yields tuples of stacked numpy arrays [B, ...]. ``shuffle`` permutes the
    (virtual) index space once; with the dataset's per-index derangement this
    matches the reference's shuffled resampling stream.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        nb = len(self)
        for b in range(nb):
            yield order[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self):
        """Bounded-prefetch iteration.

        Host memory is O(prefetch): every in-flight decode or stored-but-
        unconsumed batch holds one semaphore slot, acquired *before* a worker
        claims a ticket and released only when the consumer yields the batch.
        Workers therefore stall when the consumer does (e.g. during the
        interleaved eval pauses) instead of filling the results dict without
        bound. The consumer blocks on a condition variable rather than
        spin-polling. Mirrors torch DataLoader's bounded prefetch behaviour
        (the reference's train.py:125).
        """
        index_queue: queue.Queue = queue.Queue()
        n_batches = len(self)
        for ticket, idxs in enumerate(self._batches()):
            index_queue.put((ticket, idxs))

        results: dict[int, tuple] = {}
        cond = threading.Condition()
        slots = threading.Semaphore(max(1, self.prefetch))
        stop = threading.Event()
        errors: list[BaseException] = []

        def worker():
            while not stop.is_set():
                # acquire a prefetch slot BEFORE claiming a ticket, so the
                # slot holders are always (up to races) the earliest pending
                # tickets and the consumer can never deadlock waiting on a
                # ticket whose worker is blocked on a slot
                if not slots.acquire(timeout=0.1):
                    continue
                try:
                    ticket, idxs = index_queue.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    samples = [self.dataset[int(i)] for i in idxs]
                    batch = tuple(np.stack(cols) for cols in zip(*samples))
                except BaseException as e:  # surface decode errors to consumer
                    with cond:
                        errors.append(e)
                        cond.notify_all()
                    slots.release()
                    return
                with cond:
                    results[ticket] = batch
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            next_ticket = 0
            while next_ticket < n_batches:
                with cond:
                    while next_ticket not in results:
                        if errors:
                            raise RuntimeError("loader worker failed") from errors[0]
                        if not any(t.is_alive() for t in threads):
                            raise RuntimeError("loader workers exited early")
                        cond.wait(timeout=0.5)
                    batch = results.pop(next_ticket)
                yield batch
                slots.release()  # frees one decode slot only once consumed
                next_ticket += 1
        finally:
            stop.set()
