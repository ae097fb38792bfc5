"""Synthetic training streams with host sharding and background prefetch
(port of `repro.data.pipeline`).

Every generator is numpy and deterministic in (seed, step), bit for bit the
reference's, so a restarted worker resumes mid-stream on the same batches:
the data side of the fault-tolerance contract. With `torch.distributed`
initialised, each rank takes its rank-th slice of the global batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_tensor


class TokenStream:
    """Zipf-distributed synthetic token stream (LM pretraining stand-in)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.a = zipf_a

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.zipf(self.a, size=(self.batch, self.seq + 1)) % self.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class ClickStream:
    """Synthetic CTR clickstream with learnable structure (not pure noise):
    the label depends on a hidden weight over the sparse ids, so models can
    fit it."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        self._w = {i: rng.normal(size=min(v, 4096)).astype(np.float32)
                   for i, v in enumerate(cfg.vocab_sizes)}

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        out: Dict[str, np.ndarray] = {}
        score = np.zeros(self.batch, np.float32)
        sparse = np.zeros((self.batch, cfg.n_sparse, cfg.multi_hot), np.int32)
        for i, v in enumerate(cfg.vocab_sizes):
            ids = rng.zipf(1.1, size=(self.batch, cfg.multi_hot)) % v
            sparse[:, i, :] = ids
            score += self._w[i][ids[:, 0] % len(self._w[i])]
        out["sparse"] = sparse
        if cfg.n_dense:
            dense = rng.normal(size=(self.batch, cfg.n_dense)).astype(
                np.float32)
            score += dense[:, 0]
            out["dense"] = dense
        out["label"] = (score > 0).astype(np.int32)
        return out


class SasrecStream:
    """Markov-ish item sequences: each next item near the previous one,
    with one uniform negative per position."""

    def __init__(self, cfg, batch: int, seed: int = 0):
        self.cfg, self.batch, self.seed = cfg, batch, seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        V, S = cfg.vocab_sizes[0], cfg.seq_len
        base = rng.integers(0, V, size=(self.batch, 1))
        steps = rng.integers(-50, 50, size=(self.batch, S + 1))
        seq = (base + np.cumsum(steps, axis=1)) % V
        return {"seq": seq[:, :-1].astype(np.int32),
                "pos_items": seq[:, 1:].astype(np.int32),
                "neg_items": rng.integers(0, V, size=(self.batch, S)
                                          ).astype(np.int32),
                "seq_mask": np.ones((self.batch, S), np.float32)}


def make_graph(n_nodes: int, avg_degree: int, d_feat: int, n_classes: int,
               seed: int = 0) -> dict:
    """Power-law community graph with label-correlated features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n_nodes)
    n_edges = n_nodes * avg_degree
    # preferential-attachment-ish: sample dst by zipf rank
    src = rng.zipf(1.3, size=n_edges) % n_nodes
    dst = rng.integers(0, n_nodes, size=n_edges)
    # homophily: rewire half the edges to same-label nodes
    same = rng.random(n_edges) < 0.5
    rng.permutation(n_nodes)          # drawn as the reference draws it
    # the reference draws one `integers(0, len(pool))` an edge in a Python
    # loop; one call with an array of bounds draws the same numbers in the
    # same order and leaves the generator in the same state (minutes to
    # seconds at ogb_products' 61M edges). A label's pool, the reference's
    # `flatnonzero(labels == c)`, is its run in the labels' stable order.
    order = np.argsort(labels, kind="stable")
    counts = np.bincount(labels, minlength=n_classes)
    starts = np.cumsum(counts) - counts
    rewired = np.flatnonzero(same)[:n_edges // 2]
    lab = labels[src[rewired]]
    dst[rewired] = order[starts[lab] + rng.integers(0, counts[lab])]
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32) * 0.5
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    feats += centers[labels]
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    return {"feats": feats, "edges": edges,
            "labels": labels.astype(np.int32),
            "mask": np.ones(n_nodes, np.float32)}


def host_slice(batch: Dict[str, np.ndarray], process_index: Optional[int]
               = None, process_count: Optional[int] = None):
    """This rank's slice of the global batch (data-loader sharding). The
    rank and world size default to `torch.distributed`'s when it is
    initialised, else to (0, 1)."""
    dist = torch.distributed
    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None \
        else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None \
        else process_count

    def sl(x):
        per = x.shape[0] // pc
        return x[pi * per:(pi + 1) * per]
    return {k: sl(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of generator batches onto `device`
    (default: the card), `depth` batches ahead."""

    def __init__(self, gen_fn, depth: int = 2, device: DeviceLike = None):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.device = resolve_device(device)
        self._stop = threading.Event()

        def work():
            step = 0
            while not self._stop.is_set():
                b = {k: to_tensor(v, self.device)
                     for k, v in gen_fn(step).items()}
                while not self._stop.is_set():
                    try:
                        self.q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        pass
                step += 1

        self._t = threading.Thread(target=work, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def stop(self, timeout: float = 5.0):
        """Stops the worker thread and drops the batches it made."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout)
