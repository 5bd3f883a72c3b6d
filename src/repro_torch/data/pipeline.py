"""Deterministic synthetic data pipeline with host-side prefetch.

Counterpart of :mod:`repro.data.pipeline`.  An infinite, restartable token
stream: every batch is a pure function of (seed, step), drawn with numpy
exactly as the reference draws it, so both packages see the same batches bit
for bit.  Zipfian token ids, document boundaries every ~``doc_len`` tokens,
labels = next token.  The prefetch thread moves each batch to the device
(``.to(device, non_blocking=True)`` from pinned host memory on a card).
Sharding a batch over data-parallel replicas is not ported (ROADMAP A9).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.devices import DeviceLike, resolve_device


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_a: float = 1.2
    doc_len: int = 512
    prefetch: int = 2


class SyntheticLM:
    """Deterministic synthetic LM batches: ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig, arch=None):
        self.cfg = cfg
        self.arch = arch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        B, S = cfg.global_batch, cfg.seq_len
        # zipf-ish ids via inverse-power transform, bounded to vocab
        u = rng.random((B, S + 1))
        ids = np.minimum((u ** (-1.0 / cfg.zipf_a) - 1.0).astype(np.int64),
                         cfg.vocab - 1).astype(np.int32)
        # document boundaries: reset marker token 0
        pos = np.arange(S + 1)[None, :]
        offs = rng.integers(0, cfg.doc_len, (B, 1))
        ids = np.where((pos + offs) % cfg.doc_len == 0, 0, ids)
        out = {"tokens": ids[:, :S], "labels": ids[:, 1:]}
        if self.arch is not None and self.arch.is_encdec:
            d = self.arch.d_model
            out = {
                "frames": rng.standard_normal((B, S, d)).astype(np.float32) * 0.1,
                "dec_tokens": ids[:, :S], "labels": ids[:, 1:],
            }
        elif self.arch is not None and self.arch.frontend == "vision_stub":
            d = self.arch.d_model
            out["patches"] = rng.standard_normal((B, 256, d)).astype(np.float32) * 0.1
        return out

    def stream(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-side prefetch thread: overlaps batch synthesis and the copy to
    the device with the step (the data-pipeline analogue of the paper's copy
    streams)."""

    def __init__(self, it: Iterator, put_fn=None, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._put = put_fn or (lambda x: x)
        self._it = it
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._put(item))
        except BaseException as e:   # surfaced on the next __next__
            self._err = e
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise (self._err or StopIteration)
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def to_device(batch: Dict[str, np.ndarray], device: DeviceLike
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (pinned, non-blocking on a card)."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(dev, non_blocking=True)
    return out


def make_loader(cfg: DataConfig, device: DeviceLike, arch=None,
                start_step: int = 0) -> Prefetcher:
    """One replica's loader: the whole global batch on ``device``."""
    ds = SyntheticLM(cfg, arch)
    return Prefetcher(ds.stream(start_step),
                      lambda b: to_device(b, device), cfg.prefetch)


def make_sharded_loader(*args, **kwargs):
    """Per-replica batch shards over (pod, data): not ported yet."""
    raise NotImplementedError(
        "sharding batches over data-parallel replicas is not ported yet: "
        "ROADMAP A9; use make_loader for one replica")
