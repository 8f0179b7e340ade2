"""Background data loading (counterpart of `scenedino_tpu/utils/prefetch.py`).

  * `ThreadedLoader`: worker threads run `dataset[i]` and the collation
    ahead of the consumer, in batch order (numpy releases the GIL).
  * `device_prefetch`: keeps `buffer_size` batches already sent to the
    device; `to_device` copies from pinned host memory with
    `non_blocking=True`, so the copy overlaps the host's work.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch


def collate(samples: Sequence[dict], keys: Optional[Sequence[str]] = None) -> dict:
    """Stack a list of sample dicts into a batch dict of arrays."""
    keys = keys if keys is not None else list(samples[0].keys())
    out = {}
    for k in keys:
        vals = [s[k] for s in samples]
        try:
            out[k] = np.stack(vals)
        except (ValueError, TypeError):
            out[k] = vals  # ragged (e.g. 3d_bboxes): keep as list
    return out


class ThreadedLoader:
    """Ordered multi-threaded batch loader over an indexable dataset.

    iter(loader) yields collated batches for `index_batches` (a sequence
    of index lists, e.g. from a shuffled epoch plan). `num_workers`
    threads run __getitem__ concurrently, `prefetch_batches` bounds how
    far ahead of the consumer they get.
    """

    def __init__(
        self,
        dataset,
        index_batches: Sequence[Sequence[int]],
        num_workers: int = 4,
        prefetch_batches: int = 4,
        keys: Optional[Sequence[str]] = None,
    ):
        self.dataset = dataset
        self.index_batches = index_batches
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.keys = keys

    def __len__(self):
        return len(self.index_batches)

    def __iter__(self) -> Iterator[dict]:
        ds = self.dataset

        def load_batch(idxs):
            return collate([ds[i] for i in idxs], self.keys)

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = iter(self.index_batches)
            try:
                for _ in range(self.prefetch_batches):
                    pending.append(pool.submit(load_batch, next(it)))
            except StopIteration:
                pass
            while pending:
                fut = pending.pop(0)
                try:
                    pending.append(pool.submit(load_batch, next(it)))
                except StopIteration:
                    pass
                yield fut.result()


def to_device(batch: dict, device, keys: Optional[Sequence[str]] = None) -> dict:
    """The array entries of a host batch (those in `keys`, default all) as
    tensors on `device`: through pinned memory and a non-blocking copy
    when the device is a GPU."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if (keys is not None and k not in keys) or not isinstance(v, np.ndarray):
            continue
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t.to(device)
    return out


def device_prefetch(host_iter: Iterable, put: Callable[[dict], dict], buffer_size: int = 2):
    """Keep `buffer_size` batches already sent to the device.

    `put` maps a host batch to its device form (e.g. `to_device`). It runs
    in a daemon thread, so the copies are issued while the step runs; an
    exception there is raised on the consumer's side.
    """
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    _END = object()
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that aborts when the consumer is gone — otherwise
        an abandoned generator would pin buffer_size device-resident
        batches (and this thread) for the process lifetime."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in host_iter:
                if stop.is_set() or not _put(put(batch)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        # consumer closed early (break / exception / GeneratorExit):
        # release the worker and drop any buffered device batches
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
