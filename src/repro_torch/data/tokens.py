"""Token data pipeline for LM training (port of ``repro.data.tokens``).

An infinite stream of fixed-size batches, deterministic given ``(seed,
step)``, with a resumable cursor: restarting from step N reproduces batch
N + 1 exactly.  Token ids are Zipf-distributed (the power-law family of
the paper's R-MAT streams, which is what makes the embedding-gradient
stream hypersparse with hot keys).  :class:`TokenStream` is numpy, as in
the reference, so its batches are bit-identical to the reference's.

:class:`Prefetcher` overlaps batch synthesis with the card's work in a
background thread and hands batches over as torch tensors, on the card
unless ``device="cpu"`` (the reference's ``jnp.asarray`` hand-off).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device


class TokenStream:
    def __init__(
        self,
        vocab: int,
        batch: int,
        seq: int,
        seed: int = 0,
        zipf: float = 1.3,
        start_step: int = 0,
        frontend_shape: Optional[tuple] = None,
    ):
        self.vocab = vocab
        self.batch = batch
        self.seq = seq
        self.seed = seed
        self.zipf = zipf
        self.step = start_step
        self.frontend_shape = frontend_shape
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks**-zipf
        self._p = p / p.sum()

    # deterministic-given-(seed, step): the checkpoint cursor is just `step`
    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        tokens = rng.choice(self.vocab, size=(self.batch, self.seq), p=self._p)
        tokens = tokens.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((self.batch, 1), -100, np.int32)], axis=1
        )
        out = {"tokens": tokens, "labels": labels}
        if self.frontend_shape is not None:
            out["frontend"] = rng.normal(size=(self.batch,) + self.frontend_shape).astype(
                np.float32
            ) * 0.02
        return out

    def __next__(self):
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def cursor(self) -> int:
        return self.step

    def seek(self, step: int):
        self.step = step


_SENTINEL = object()  # producer's last word: "no more batches are coming"


class Prefetcher:
    """Double-buffered background prefetch: overlaps host batch synthesis /
    IO with device compute.  ``close()`` drains the thread and joins it
    unbounded — a timed join can leak a live thread still holding the
    stream's file handle on a slow box."""

    def __init__(self, stream: TokenStream, depth: int = 2, device=None):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        dev = resolve_device(device)
        self._put = lambda b: {k: torch.from_numpy(x).to(dev) for k, x in b.items()}

        def work():
            try:
                while not self._stop.is_set():
                    try:
                        b = next(self.stream)
                    except StopIteration:
                        break  # normal end-of-stream, not an error
                    while not self._stop.is_set():
                        try:
                            self.q.put(self._put(b), timeout=0.05)
                            break
                        except queue.Full:
                            continue  # retry until consumer catches up/stops
            finally:
                # always signal end-of-stream, even on an exception: a
                # blocked consumer must wake instead of waiting forever.
                # While the queue is full a consumer is still reading: wait
                # for room.  Once close() has begun, evict a batch to make
                # room instead (the producer is the only putter by now, so
                # this terminates).
                while True:
                    try:
                        self.q.put(_SENTINEL, timeout=0.05)
                        break
                    except queue.Full:
                        if self._stop.is_set():
                            try:
                                self.q.get_nowait()
                            except queue.Empty:
                                pass

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __next__(self):
        item = self.q.get()
        if item is _SENTINEL:
            self.q.put(_SENTINEL)  # keep signalling any other consumer
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        # drain to unblock a producer stuck in put(); the sentinel in the
        # work loop's finally guarantees the thread exits, so the unbounded
        # join below cannot hang
        while self._thread.is_alive():
            try:
                self.q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()
