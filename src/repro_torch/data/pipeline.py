"""Deterministic, resumable, host-sharded data pipeline (a copy of
``repro.data.pipeline``, numpy and a thread; no torch).

- every host computes its shard of each global batch *statelessly* from
  ``(step, host_id)``: batch ``step`` draws its window starts from
  ``np.random.default_rng(seed + step)``, so a restart re-materializes
  the same batches bit for bit (a checkpoint stores only ``step``);
- a background prefetch thread keeps ``prefetch`` batches ready;
- elastic: on a device-count change the loader is re-instantiated with
  the new ``(host_id, n_hosts)`` and the same step cursor.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["ShardedLoader"]


class ShardedLoader:
    """Iterates ``(tokens, targets)`` host-shards of a synthetic LM stream."""

    def __init__(self, stream: np.ndarray, *, global_batch: int, seq_len: int,
                 host_id: int = 0, n_hosts: int = 1, start_step: int = 0,
                 prefetch: int = 2, seed: int = 0):
        if global_batch % n_hosts:
            raise ValueError(f"global batch {global_batch} must split over "
                             f"{n_hosts} hosts")
        self.stream = stream
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.step = start_step
        self.seed = seed
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- stateless batch materialization ------------------------------------
    def _materialize(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        n = len(self.stream) - self.seq_len - 1
        rng = np.random.default_rng(self.seed + step)           # step-keyed
        starts = rng.integers(0, n, size=self.global_batch)
        lo = self.host_id * self.local_batch
        starts = starts[lo:lo + self.local_batch]
        idx = starts[:, None] + np.arange(self.seq_len + 1)[None, :]
        window = self.stream[idx]
        return window[:, :-1].copy(), window[:, 1:].copy()

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._materialize(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        step, batch = self._q.get()
        self.step = step + 1          # cursor for checkpointing
        return batch

    def __iter__(self):
        return self

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    @classmethod
    def resume(cls, stream: np.ndarray, state: dict, **kw) -> "ShardedLoader":
        return cls(stream, start_step=state["step"], seed=state["seed"], **kw)
