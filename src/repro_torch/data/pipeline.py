"""Batching pipeline: host-side token batches and the federated LM corpus.

``lm_batches`` yields token batches for a plain trainer;
``federated_lm_corpus`` builds the engine-ready per-client sequence shards
that give transformer clients non-IID heterogeneity (the ``corpus_skew``
scenario, the text analogue of ``label_skew``).  Plain numpy with the
reference's draws in the reference's order, so the arrays are
bit-identical to ``repro.data.pipeline``'s for the same seed.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from repro_torch.common.config import ModelConfig
from repro_torch.data.scenarios import make_scenario, plan_sizes
from repro_torch.data.synthetic import token_stream


def lm_batches(
    cfg: ModelConfig,
    *,
    batch: int,
    seq: int,
    steps: int,
    seed: int = 0,
    patches: bool = False,
) -> Iterator[dict]:
    """Token batches for any LM config; adds stub patch embeddings (batch,
    ``cfg.num_patches``, 1024) for the vision frontend."""
    rng = np.random.default_rng(seed + 7)
    for b in token_stream(steps, batch, seq, cfg.vocab_size, seed=seed):
        if patches or cfg.frontend == "vision_stub":
            b["patches"] = rng.standard_normal(
                (batch, cfg.num_patches, 1024)
            ).astype(np.float32)
        yield b


def _topic_sequences(rng, n: int, seq: int, vocab: int, probs, succ
                     ) -> np.ndarray:
    """n sequences of length seq+1 from one topic's process: each step
    follows the topic's favored-successor table with probability 1/2, else
    redraws from the topic's unigram distribution."""
    t = np.empty((n, seq + 1), np.int64)
    t[:, 0] = rng.choice(vocab, size=n, p=probs)
    for s in range(seq):
        fresh = rng.choice(vocab, size=n, p=probs)
        follow = rng.random(n) < 0.5
        t[:, s + 1] = np.where(follow, succ[t[:, s]], fresh)
    return t


def _topic_rows(rng, topic_of, topics: int, seq: int, vocab: int, probs, succ):
    """(tokens, labels) int64 (len(topic_of), seq), topic by topic."""
    tokens = np.empty((len(topic_of), seq), np.int64)
    labels = np.empty((len(topic_of), seq), np.int64)
    for k in range(topics):
        rows = np.where(topic_of == k)[0]
        if rows.size == 0:
            continue
        t = _topic_sequences(rng, rows.size, seq, vocab, probs[k], succ[k])
        tokens[rows] = t[:, :-1]
        labels[rows] = t[:, 1:]
    return tokens, labels


def federated_lm_corpus(
    num_clients: int,
    *,
    vocab: int,
    seq: int,
    samples_per_client: int,
    topics: int = 8,
    scenario: str = "corpus_skew",
    alpha: float = 0.3,
    eval_sequences: int = 64,
    poisoners: Tuple[int, ...] = (),
    seed: int = 0,
) -> Tuple[dict, dict]:
    """Topic-conditioned synthetic corpus, partitioned non-IID over clients.

    Each topic has its own Zipf unigram distribution (over a
    topic-permuted vocab) and its own favored-successor table.  The pool's
    per-sequence topic ids feed ``make_scenario(scenario, ...)`` (default
    ``corpus_skew``: Dirichlet(alpha) topic skew), giving ragged
    per-client shards padded to ``(N, n_max, S)`` with a bool sample mask.
    Clients in ``poisoners`` get their labels scrambled to uniform random
    tokens (a label-flip attack in LM form).

    Returns ``(data, meta)``: ``data`` holds ``tokens``, ``labels`` int32
    (N, n_max, S), ``sizes`` float32 (N,) and ``mask`` bool (N, n_max)
    (omitted when the shards come out rectangular); ``meta`` holds
    ``topic_of`` (the pool's topic ids), ``plan`` (the ScenarioPlan) and
    ``eval``, a held-out ``{"tokens", "labels"}`` drawn from the uniform
    topic mixture.
    """
    if not 1 <= topics <= vocab:
        raise ValueError(f"need 1 <= topics <= vocab, got topics={topics} "
                         f"vocab={vocab}")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    base = (1.0 / ranks) / np.sum(1.0 / ranks)

    topic_probs = np.empty((topics, vocab))
    topic_succ = np.empty((topics, vocab), np.int64)
    for k in range(topics):
        perm = rng.permutation(vocab)
        topic_probs[k, perm] = base
        topic_succ[k] = rng.integers(0, vocab, vocab)

    pool = num_clients * samples_per_client
    topic_of = rng.integers(0, topics, pool)
    tokens_pool, labels_pool = _topic_rows(rng, topic_of, topics, seq, vocab,
                                           topic_probs, topic_succ)

    plan = make_scenario(scenario, topic_of, num_clients, samples_per_client,
                         seed=seed, alpha=alpha)
    sizes = plan_sizes(plan)
    n_max = max(int(sizes.max()), 1)
    tokens = np.zeros((num_clients, n_max, seq), np.int32)
    labels = np.zeros((num_clients, n_max, seq), np.int32)
    mask = np.zeros((num_clients, n_max), bool)
    for i, idx in enumerate(plan.client_indices):
        n = len(idx)
        tokens[i, :n] = tokens_pool[idx]
        labels[i, :n] = labels_pool[idx]
        mask[i, :n] = True

    for i in poisoners:
        labels[i] = rng.integers(0, vocab, labels[i].shape)

    data = {
        "tokens": tokens,
        "labels": labels,
        "sizes": sizes.astype(np.float32),
    }
    if not mask.all():
        data["mask"] = mask

    ev_topics = rng.integers(0, topics, eval_sequences)
    ev_tokens, ev_labels = _topic_rows(rng, ev_topics, topics, seq, vocab,
                                       topic_probs, topic_succ)
    meta = {
        "topic_of": topic_of,
        "plan": plan,
        "eval": {
            "tokens": ev_tokens.astype(np.int32),
            "labels": ev_labels.astype(np.int32),
        },
    }
    return data, meta
