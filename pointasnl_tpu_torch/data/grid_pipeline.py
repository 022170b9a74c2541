"""Shared machinery for the grid (KPConv-style) dataset pipelines, the port's
copy of ``pointasnl_tpu/data/grid_pipeline.py`` (numpy and threads; the same
seeds give the same arrays, to the bit).

The reference assembles tf.data pipelines (generator -> map(augment,
num_parallel_calls=8) -> batch(drop_remainder) -> prefetch(10),
ScanNet/train_scannet_grid.py:144-155, flag --input_threads :47). Here the
stateful potential-based generators stay on the host (they mutate
cross-step state and produce ragged -> fixed-shape crops; the reference's
generator is equally serial) and the graph plumbing becomes:
  - vectorized numpy augmentation identical to tf_augment_input
    (scannet_dataset_grid.py:586-645): per-cloud vertical rotation,
    anisotropic scale 0.9-1.1 with optional axis symmetry flips, sigma=0.001
    gaussian noise; plus the random color-drop (:564-568);
  - `parallel_map`: an ordered thread-pool map over the generator — the
    num_parallel_calls analog (numpy kernels release the GIL, so threads
    genuinely overlap the augment work and the generator's KD-tree queries);
  - a background-thread prefetcher feeding fixed-shape numpy batches, while
    the card runs the steps already queued (CUDA launches are asynchronous).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class GridConfig:
    """Pipeline/augmentation knobs (the reference folds these into args)."""

    batch_size: int = 8
    epoch_steps: int = 600
    validation_size: int = 50
    in_radius: float = 0.0  # >0: radius crop; 0: kNN crop of npoint+buffer
    augment_scale_anisotropic: bool = True
    augment_scale_min: float = 0.9
    augment_scale_max: float = 1.1
    augment_noise: float = 0.001
    augment_color: float = 1.0  # probability a cloud KEEPS its colors
    augment_rotation: str = "vertical"
    augment_symmetries: Sequence[bool] = field(default_factory=lambda: [True, False, False])
    # Worker threads for the augment/map stage (reference --input_threads,
    # num_parallel_calls=8). 0 = inline map in the consumer thread.
    input_threads: int = 8


def augment_points(points: np.ndarray, config: GridConfig, rs: np.random.RandomState):
    """Augment one cloud's xyz (N, 3): rotation, anisotropic scale+flip, noise.

    Numpy equivalent of tf_augment_input (scannet_dataset_grid.py:586-645).
    Returns (augmented_points, scale(1,3), R(3,3)).
    """
    if config.augment_rotation == "vertical":
        theta = rs.uniform(0, 2 * np.pi)
        c, s = np.cos(theta), np.sin(theta)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        points = points @ R
    elif config.augment_rotation == "none":
        R = np.eye(3, dtype=np.float32)
    else:
        raise ValueError(f"Unknown rotation augmentation: {config.augment_rotation}")

    if config.augment_scale_anisotropic:
        scale = rs.uniform(config.augment_scale_min, config.augment_scale_max, (1, 3))
    else:
        scale = np.full((1, 3), rs.uniform(config.augment_scale_min, config.augment_scale_max))
    for i in range(3):
        if config.augment_symmetries[i] and rs.random_sample() < 0.5:
            scale[0, i] *= -1
    points = points * scale.astype(np.float32)

    noise = rs.randn(*points.shape).astype(np.float32) * config.augment_noise
    return points + noise, scale.astype(np.float32), R


def maybe_drop_colors(colors: np.ndarray, config: GridConfig, rs: np.random.RandomState):
    """Randomly zero a cloud's colors with prob 1 - augment_color (:564-568)."""
    if rs.random_sample() >= config.augment_color:
        return np.zeros_like(colors)
    return colors


# The crops' searches on a scipy ``cKDTree`` of a subsampled cloud. A ball's
# indices come in ascending order: sklearn's, which the JAX package keeps,
# follow its tree's layout. kNN results come nearest first, as sklearn's.


def ball_indices(tree, center: np.ndarray, radius: float) -> np.ndarray:
    """Indices of the points of `tree` within `radius` of the one point
    `center` ((3,) or (1, 3)), in ascending order."""
    inds = tree.query_ball_point(np.reshape(center, -1), r=radius, return_sorted=True)
    return np.asarray(inds, dtype=np.intp)


def knn_indices(tree, center: np.ndarray, k: int) -> np.ndarray:
    """Indices of the `k` points of `tree` nearest the one point `center`,
    nearest first."""
    return np.atleast_1d(tree.query(np.reshape(center, -1), k=k)[1])


def nearest_indices(tree, points: np.ndarray) -> np.ndarray:
    """int32 index of the nearest point of `tree` for each of `points`."""
    return tree.query(points, k=1)[1].astype(np.int32)


def batch_iterator(
    gen_fn: Callable[[], Iterator],
    batch_size: int,
    *,
    drop_remainder: bool = True,
) -> Iterator[List]:
    """Group per-example tuples into lists of length batch_size."""
    buf: List = []
    for item in gen_fn():
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_remainder:
        yield buf


class Prefetcher:
    """Background-thread prefetch over an iterator (tf.data prefetch analog).

    Worker exceptions propagate to the consumer at the point of the failed
    item. `close()` (or exhausting the iterator) stops the worker and joins
    it — a consumer that exits its loop early must not leave the worker
    blocked forever on a full queue, so puts poll a stop event.
    """

    _DONE = object()

    def __init__(self, iterator: Iterator, capacity: int = 8):
        self.q: "queue.Queue" = queue.Queue(maxsize=capacity)
        self.err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._finished = False

        def _put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterator:
                    if not _put(item):
                        return
            except BaseException as e:  # propagate to consumer
                self.err = e
            finally:
                _put(self._DONE)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def close(self) -> None:
        """Stop the worker and join it (idempotent; safe mid-iteration)."""
        self._stop.set()
        # unblock a worker waiting on a full queue
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=10.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self.q.get()
        if item is self._DONE:
            self._finished = True
            if self.err is not None:
                err, self.err = self.err, None
                raise err
            raise StopIteration
        return item


class parallel_map:
    """Ordered thread-pool map over an iterator — the tf.data
    `map(fn, num_parallel_calls=N)` analog (train_scannet_grid.py:145-147).

    A feeder thread pulls items from `iterator` (serial, as the stateful
    potential generators require) and submits `fn(item)` to a pool of
    `num_threads` workers, keeping up to `prefetch` results in flight;
    results are yielded in input order. With ``num_threads == 0`` the map
    runs inline in the consumer thread (same output, no concurrency).

    Exceptions from `fn` or from the iterator surface in the consumer at the
    corresponding position. Early consumer exit: `close()` (also wired to
    `__exit__`) stops the feeder and shuts the pool down without deadlock.
    """

    _DONE = object()

    def __init__(self, iterator: Iterator, fn: Callable, num_threads: int,
                 prefetch: int = 10):
        self.fn = fn
        self.inline = num_threads <= 0
        if self.inline:
            self._it = iter(iterator)
            return
        self._stop = threading.Event()
        self._finished = False
        self.pool = ThreadPoolExecutor(max_workers=num_threads,
                                       thread_name_prefix="pmap")
        self.q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, num_threads))
        self.err: Optional[BaseException] = None

        def _put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def feeder():
            try:
                for item in iterator:
                    fut = self.pool.submit(fn, item)
                    if not _put(fut):
                        fut.cancel()
                        return
            except BaseException as e:  # generator error -> consumer
                self.err = e
            finally:
                _put(self._DONE)

        self.thread = threading.Thread(target=feeder, daemon=True)
        self.thread.start()

    def close(self) -> None:
        if self.inline:
            return
        self._stop.set()
        while True:
            try:
                item = self.q.get_nowait()
                if item is not self._DONE:
                    item.cancel()
            except queue.Empty:
                break
        self.thread.join(timeout=10.0)
        self.pool.shutdown(wait=False, cancel_futures=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self.inline:
            return self.fn(next(self._it))
        if self._finished:
            raise StopIteration
        fut = self.q.get()
        if fut is self._DONE:
            self._finished = True
            err, self.err = self.err, None
            self.close()
            if err is not None:
                raise err
            raise StopIteration
        return fut.result()  # re-raises fn's exception in order
