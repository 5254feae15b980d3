"""Deterministic, resumable data pipeline (counterpart of
``repro/data/pipeline.py``, copied in numpy: for the same configuration,
shape, seed and step the batches are bitwise those of the JAX package).

Every batch is a pure function of ``(seed, step)``, so a restart from a
checkpoint resumes the stream exactly.  Sources:

* ``SyntheticLM``: a Zipf-distributed token stream (crossmodal configs get
  the stub vision regions and VQA answers instead of labels, the
  encoder-decoder the stub frontend's frames, a VLM three equal position
  streams);
* ``TextCorpus``: byte-level tokens of local files packed into rows.

``ShardedLoader`` wraps a source with host sharding (each host keeps its
slice of the global batch) and a prefetch thread.  The port runs on one
host, so it defaults to one.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.core.types import Family, ModelConfig, ShapeConfig


class SyntheticLM:
    """Zipf token stream: batch(step) is deterministic in (seed, step)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 zipf_a: float = 1.2):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.zipf_a = zipf_a

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        B, S = self.shape.global_batch, self.shape.seq_len
        V = self.cfg.vocab_size
        toks = rng.zipf(self.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % V
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.family == Family.VLM:
            pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                                  (3, B, S))
            out["positions"] = np.ascontiguousarray(pos)
        if self.cfg.family == Family.ENCDEC:
            out["frames"] = rng.standard_normal(
                (B, self.cfg.encoder_seq, self.cfg.d_model)).astype(
                    np.float32) * 0.1
        if self.cfg.family == Family.CROSSMODAL:
            out = {"regions": rng.standard_normal(
                       (B, S, self.cfg.d_model)).astype(np.float32) * 0.1,
                   "tokens": out["tokens"],
                   "answers": rng.integers(0, 3129, size=(B,)).astype(
                       np.int32)}
        return out


class TextCorpus:
    """Byte-tokenized local files packed to fixed-length rows; batch(step)
    picks rows with a per-step generator, so restart is exact."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, path: str,
                 seed: int = 0):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        blobs = []
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                p = os.path.join(path, name)
                if os.path.isfile(p):
                    with open(p, "rb") as f:
                        blobs.append(np.frombuffer(f.read(), np.uint8))
        else:
            with open(path, "rb") as f:
                blobs.append(np.frombuffer(f.read(), np.uint8))
        data = np.concatenate(blobs) if blobs else np.zeros((1,), np.uint8)
        S = shape.seq_len
        n_rows = max(len(data) // (S + 1), 1)
        reps = -(-n_rows * (S + 1) // len(data))
        data = np.tile(data, max(reps, 1))[:n_rows * (S + 1)]
        self.rows = data.reshape(n_rows, S + 1).astype(np.int32) % \
            cfg.vocab_size

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, len(self.rows), size=(self.shape.global_batch,))
        rows = self.rows[idx]
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


class ShardedLoader:
    """Host-sharded, prefetching iterator over a deterministic source."""

    def __init__(self, source, *, start_step: int = 0, prefetch: int = 2,
                 host_count: int = 1, host_id: int = 0):
        self.source = source
        self.host_count = host_count
        self.host_id = host_id
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _shard(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = {}
        for k, v in batch.items():
            if k == "positions":           # (3, B, S): shard dim 1
                b = v.shape[1] // self.host_count
                out[k] = v[:, self.host_id * b:(self.host_id + 1) * b]
            else:
                b = v.shape[0] // self.host_count
                out[k] = v[self.host_id * b:(self.host_id + 1) * b]
        return out

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self._shard(self.source.batch(step))
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
