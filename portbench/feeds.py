"""How a cell's batches reach the training step, as its traffic file says
(``"feed"``).

- ``resident``: a pool of ``pool_batches`` x B distinct stacks made on the
  card at set-up; batch i is the (i mod pool_batches)-th block of B rows, a
  view of the pool, with its K pyramids. Nothing crosses from the host.
- ``loader``: ``stacks`` PNG stacks written at set-up in the layout of a
  prepared KITTI tree (``train.txt``, a calibration file) under a new
  directory of ``TMPDIR``, read by the port's ``KittiPreparedDataset`` and
  ``BatchLoader`` (``num_workers`` threads, ``prefetch`` batches ahead) and
  copied to the card by ``parallel.to_device_batch``, as the training CLI
  does. The decoded-stack cache holds ``decode_cache_share`` of the tree.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from unsupervised_depth_opticalflow_egomotion_torch.data import BatchLoader, KittiPreparedDataset
from unsupervised_depth_opticalflow_egomotion_torch.parallel import to_device_batch

from . import traffic as gen


def load_traffic(name: str) -> dict:
    t = gen.load(name)
    t["name"] = name
    return t


def _traffic_generator(seed: int, device) -> torch.Generator:
    # a stream of its own, apart from the weights' (seeded with ``seed``)
    return torch.Generator(device=device).manual_seed(seed ^ 0x5DEECE66D)


class ResidentFeed:
    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        b, (h, w), ns = cfg["batch_size"], cfg["img_hw"], cfg["num_scales"]
        self.b, self.blocks = b, int(traffic["pool_batches"])
        g = _traffic_generator(seed, device)
        self.images = gen.stacks(self.blocks * b, h, w, traffic["texture"], g, device)
        K, K_inv = gen.intrinsics(h, w, ns, traffic["intrinsics"]["fx"], traffic["intrinsics"]["fy"])
        self.K = K.to(device).expand(b, ns, 3, 3).contiguous()
        self.K_inv = K_inv.to(device).expand(b, ns, 3, 3).contiguous()
        self.i = 0

    def batch(self, i: int) -> tuple:
        j = (i % self.blocks) * self.b
        return self.images[j:j + self.b], self.K, self.K_inv

    def next(self) -> tuple:
        out = self.batch(self.i)
        self.i += 1
        return out

    def checked(self, n: int) -> list:
        """The first ``n`` batches, as the reference gets them."""
        return [self.batch(i) for i in range(n)]

    def close(self) -> None:
        pass


class LoaderFeed:
    def __init__(self, traffic: dict, cfg: dict, seed: int, device):
        b, (h, w), ns = cfg["batch_size"], cfg["img_hw"], cfg["num_scales"]
        self.b, self.hw, self.ns, self.device = b, (h, w), ns, device
        self.intr = traffic["intrinsics"]
        self.root = tempfile.mkdtemp(prefix="portbench_pngs_")
        self.files = write_tree(self.root, int(traffic["stacks"]), h, w, traffic, seed, device)
        stack_bytes = 3 * h * w * 3
        self.loader_seed = seed % (1 << 31)
        self.dataset = KittiPreparedDataset(
            self.root, num_scales=ns, img_hw=(h, w), num_iterations=b * int(traffic["max_steps"]),
            seed=self.loader_seed, uint8_images=True,
            cache_decoded_bytes=int(traffic["decode_cache_share"] * len(self.files) * stack_bytes))
        self.it = iter(BatchLoader(self.dataset, b, shuffle=True,
                                   num_workers=int(traffic["num_workers"]),
                                   prefetch=int(traffic["prefetch"]), seed=self.loader_seed))
        self.keep = int(traffic["checked_steps"])
        self.taken = []  # the loader's first batches, for the check

    def next(self) -> tuple:
        out = to_device_batch(next(self.it), self.device)
        if len(self.taken) < self.keep:
            self.taken.append(out)
        return out

    def checked(self, n: int) -> list:
        """The first ``n`` batches as the reference decodes them itself from
        the files, by the loader's documented sampling."""
        return [reference_batch(self, i) for i in range(n)]

    def close(self) -> None:
        self.it.close()
        shutil.rmtree(self.root, ignore_errors=True)


def write_tree(root: str, n: int, h: int, w: int, traffic: dict, seed: int, device) -> list:
    """``n`` stacks as PNGs, ``calib.txt`` and ``train.txt`` under ``root``."""
    os.makedirs(os.path.join(root, "d"))
    g = _traffic_generator(seed, device)
    files = [os.path.join(root, "d", f"{i:06d}.png") for i in range(n)]
    with ThreadPoolExecutor(4) as pool:
        futures = []
        for lo in range(0, n, 16):
            block = gen.stacks(min(16, n - lo), h, w, traffic["texture"], g, device).cpu().numpy()
            futures += [pool.submit(gen.write_png, files[lo + j], block[j]) for j in range(len(block))]
        for f in futures:
            f.result()
    fx, fy = traffic["intrinsics"]["fx"], traffic["intrinsics"]["fy"]
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write(f"P_rect_02: {fx} 0.0 {w / 2} 0.0 0.0 {fy} {h / 2} 0.0 0.0 0.0 1.0 0.0\n")
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.writelines(f"d/{i:06d}.png calib.txt\n" for i in range(n))
    return files


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG of filter 0 rows (as ``traffic.write_png`` writes)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, (w, h) = 8, b"", (0, 0)
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def reference_batch(feed: LoaderFeed, i: int) -> tuple:
    """Batch ``i`` of the loader's stream, by its documented sampling: the
    virtual indices in ``RandomState(seed)``'s shuffle, each drawing its
    stack with ``RandomState(seed + index).randint(N)`` and a whole-stack
    horizontal flip when the next draw exceeds 0.5; frames in BGR, as an
    OpenCV decode gives them."""
    n = len(feed.dataset)
    order = np.arange(n)
    np.random.RandomState(feed.loader_seed).shuffle(order)
    imgs = []
    for idx in order[i * feed.b:(i + 1) * feed.b]:
        rng = np.random.RandomState(feed.loader_seed + int(idx))
        img = read_png(feed.files[rng.randint(len(feed.files))])[:, :, ::-1]
        if rng.rand() > 0.5:
            img = img[:, ::-1]
        imgs.append(np.ascontiguousarray(img))
    h, w = feed.hw
    K, K_inv = gen.intrinsics(h, w, feed.ns, feed.intr["fx"], feed.intr["fy"])
    rep = lambda t: t.expand(feed.b, *t.shape).contiguous()  # noqa: E731
    return torch.from_numpy(np.stack(imgs)), rep(K), rep(K_inv)


FEEDS = {"resident": ResidentFeed, "loader": LoaderFeed}


def make_feed(traffic: dict, cfg: dict, seed: int, device):
    return FEEDS[traffic["feed"]](traffic, cfg, seed, device)
