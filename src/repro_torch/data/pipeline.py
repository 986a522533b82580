"""Training data pipeline staged through Pilot-Data tiers.

The paper's data-workflow story (§3.1 Fig. 3): raw data in cold storage,
pre-processed shards staged to warm storage, batches staged into memory for
the compute phase. Here: a deterministic synthetic corpus (Zipf-ish token
stream with local structure so the loss actually falls) is materialized as
file-tier DataUnit shards; the pipeline stages shard-by-shard into the host
tier, slices batches, and hands device-ready arrays to the trainer with a
background prefetch thread (overlap stage-in with compute, the paper's
'ensure data is available before the CU starts').
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.data import DataUnit
from repro_torch.core.memory import StorageBackend, make_backend


def synthesize_corpus(vocab_size: int, num_tokens: int, seed: int = 0,
                      order: int = 2) -> np.ndarray:
    """Synthetic corpus with learnable bigram structure (vectorized)."""
    rng = np.random.default_rng(seed)
    # Zipf-ish unigram over a capped alphabet for speed
    v_eff = min(vocab_size, 32768)
    ranks = np.arange(1, v_eff + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    base = rng.choice(v_eff, size=num_tokens, p=probs).astype(np.int32)
    # inject bigram determinism: token[i] = f(token[i-1]) on a fraction of
    # positions, giving the model something to learn beyond unigram entropy
    mask = rng.random(num_tokens) < 0.65
    out = base.copy()
    # two passes so mapped tokens chain (strengthens the bigram signal)
    for _ in range(2):
        mapped = (np.roll(out, 1) * 31 + 7) % v_eff
        out = np.where(mask, mapped, out).astype(np.int32)
    return out


def corpus_data_unit(name: str, cfg: ModelConfig, num_tokens: int,
                     backends: Dict[str, StorageBackend],
                     num_shards: int = 8, seed: int = 0,
                     tier: str = "file", tier_manager=None) -> DataUnit:
    corpus = synthesize_corpus(cfg.vocab_size, num_tokens, seed)
    return DataUnit.from_array(name, corpus, num_shards, backends, tier=tier,
                               tier_manager=tier_manager)


class BatchPipeline:
    """Iterator of train batches with background stage-in + prefetch.

    When the DataUnit is attached to a TierManager, shard stage-in rides
    the manager's thread-pool stager via depth-`stage_depth` prefetch
    hints, so training input staging shares the same tier budgets, heat
    accounting, and eviction policy as analytics DataUnits (one budget
    model across the system); an unmanaged DU degrades to plain reads.

    With `pilot` set (and the DU bound to a PilotDataService) shard reads
    and prefetches route through THAT pilot's own TierManager instead:
    the training input stream rides the pilot's per-pilot budget and
    replica residency, so a trainer pinned to one pilot stages against
    the memory it actually owns rather than a global pool."""

    def __init__(self, du: DataUnit, cfg: ModelConfig, batch: int,
                 seq_len: int, prefetch: int = 2, seed: int = 0,
                 stage_depth: int = 2, stage_tier: str = "host",
                 pilot=None):
        self.du = du
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.stage_depth = stage_depth
        self.stage_tier = stage_tier
        self.pilot = pilot
        self.tokens_per_batch = batch * (seq_len + 1)
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._rng = np.random.default_rng(seed)
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        shard_idx = 0
        buf = np.empty((0,), np.int32)
        while not self._stop.is_set():
            while buf.size < self.tokens_per_batch:
                if self._stop.is_set():
                    return      # bail between shard reads, not only between
                #                 batches, so close() joins promptly even on
                #                 slow (throttled) tiers
                # keep the next shards in flight on the shared stager while
                # this one is sliced (budget-refused stages are harmless)
                self.du.prefetch_window(shard_idx + 1, self.stage_depth,
                                        self.stage_tier, wrap=True,
                                        pilot=self.pilot)
                part = np.asarray(
                    self.du.partition(shard_idx % self.du.num_partitions,
                                      pilot=self.pilot))
                shard_idx += 1
                buf = np.concatenate([buf, part.reshape(-1)])
            take, buf = (buf[:self.tokens_per_batch],
                         buf[self.tokens_per_batch:])
            arr = take.reshape(self.batch, self.seq_len + 1)
            batch = {"tokens": arr[:, :-1].astype(np.int32),
                     "labels": arr[:, 1:].astype(np.int32)}
            self._add_modalities(batch)
            # retry until the consumer takes it: a slow train step must
            # stall the stream, not silently drop this batch's tokens
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def _add_modalities(self, batch):
        cfg = self.cfg
        if cfg.vision_tokens:
            batch["patch_embeds"] = self._rng.normal(
                0, 0.5, size=(self.batch, cfg.vision_tokens,
                              cfg.vision_embed_dim)).astype(np.float32)
        if cfg.encoder_layers:
            batch["frames"] = self._rng.normal(
                0, 0.5, size=(self.batch, cfg.encoder_seq_len,
                              cfg.d_model)).astype(np.float32)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        return self._q.get()

    def close(self):
        """Stop the producer deterministically (no thread leaks across
        tests): signal, unblock any pending put, and join. The join bound
        covers one in-flight shard read (simulated-profile sleeps are
        capped at 5 s)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10.0)
