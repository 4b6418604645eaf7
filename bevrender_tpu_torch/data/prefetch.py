"""Host -> device input pipeline (counterpart of
bevrender_tpu/data/prefetch.py): ``collate``, ``group_batches`` and the
map-style ``DataLoader`` are numpy only and behave as there (same seeded
shuffle, sampler, ``drop_last``, ``set_epoch``); ``device_prefetch`` moves
finished batches to the model's device from pinned memory while the
previous step computes, and applies the device-side preprocessing stage
(``data.preprocess``) to them there."""

from __future__ import annotations

import collections
import concurrent.futures
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def group_batches(it: Iterator[Dict[str, np.ndarray]],
                  k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Stack ``k`` consecutive batches into one (k, B, ...) super-batch; a
    trailing partial group comes at its natural size."""
    buf: List[Dict[str, np.ndarray]] = []
    for b in it:
        buf.append(b)
        if len(buf) == k:
            yield collate(buf)
            buf = []
    if buf:
        yield collate(buf)


class DataLoader:
    """Minimal map-style loader: seeded shuffling per epoch, batching,
    ``drop_last``, an index ``sampler`` (a K-fold split), and
    ``__getitem__`` on a thread pool, ``num_workers + 1`` batches ahead."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 2, drop_last: bool = True, seed: int = 0,
                 sampler: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.sampler = sampler
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The shuffle is seeded with ``seed + epoch``."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = (np.asarray(self.sampler) if self.sampler is not None
               else np.arange(len(self.dataset)))
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(idx)
        usable = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, usable, self.batch_size)]
        if not batches:
            return iter(())
        pool = concurrent.futures.ThreadPoolExecutor(self.num_workers)

        def load(batch_idx):
            return collate([self.dataset[int(i)] for i in batch_idx])

        def gen():
            try:
                pending = collections.deque()
                ahead = self.num_workers + 1
                for b in batches[:ahead]:
                    pending.append(pool.submit(load, b))
                next_submit = ahead
                while pending:
                    fut = pending.popleft()
                    if next_submit < len(batches):
                        pending.append(pool.submit(load, batches[next_submit]))
                        next_submit += 1
                    yield fut.result()
            finally:
                pool.shutdown(wait=False, cancel_futures=True)

        return gen()


def device_prefetch(it: Iterator[Dict[str, np.ndarray]], device,
                    size: int = 2, preprocess: Optional[Callable] = None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Keep ``size`` batches in flight on ``device``. A feeder thread turns
    each numpy batch into tensors; for a CUDA device it pins them and
    copies on a side stream, then runs ``preprocess`` (a device batch to a
    device batch) on that stream, and the consumer's stream waits for the
    batch only when it takes it. Errors of the dataset surface in the
    consumer."""
    device = torch.device(device)
    on_gpu = device.type == "cuda"
    stream = torch.cuda.Stream(device) if on_gpu else None
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    end = object()

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not on_gpu:
            return (preprocess(host) if preprocess else host), None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(device, non_blocking=True)
                   for k, t in host.items()}
            if preprocess is not None:
                out = preprocess(out)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def feeder():
        try:
            for batch in it:
                q.put(put(batch))
        except BaseException as e:  # surface dataset errors to the consumer
            q.put(e)
            return
        q.put(end)

    threading.Thread(target=feeder, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            return
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            torch.cuda.current_stream(device).wait_event(done)
            for t in batch.values():  # the consumer's stream now owns them
                t.record_stream(torch.cuda.current_stream(device))
        yield batch
