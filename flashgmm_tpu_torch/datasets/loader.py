"""A multi-threaded batch loader, the torch DataLoader's stand-in (port of
flashgmm_tpu/datasets/loader.py).

Batches are built on background threads and yielded in order as stacked
numpy NHWC float32 arrays. One ``random.Random(seed)`` shuffles the
indices, so a seed gives the JAX loader's index lists in its order. A
worker's exception is raised to the consumer (the JAX loader's consumer
would wait for the batch forever).
"""

import queue
import random
import threading

import numpy as np


class BatchLoader:
    def __init__(self, dataset, batch_size, shuffle=True, num_workers=2,
                 prefetch=4, drop_last=True, seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._rng = random.Random(seed)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(indices)
        batches = [
            indices[i: i + self.batch_size]
            for i in range(0, len(indices), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        job_q = queue.Queue()
        for i, b in enumerate(batches):
            job_q.put((i, b))

        results = {}
        ready = threading.Condition()

        def worker():
            while True:
                try:
                    i, idxs = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = np.stack([self.dataset[j] for j in idxs])
                except Exception as exc:  # raised to the consumer
                    batch = exc
                with ready:
                    results[i] = batch
                    ready.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        for i in range(len(batches)):
            with ready:
                ready.wait_for(lambda: i in results)
                batch = results.pop(i)
            if isinstance(batch, Exception):
                raise batch
            yield batch
