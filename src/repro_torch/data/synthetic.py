"""Deterministic synthetic data (numpy only).

Copies of ``clustered_vectors`` (an ANN corpus), of ``MarkovLM``,
``make_markov_lm`` and ``lm_batch`` (a sparse Markov-chain language for
LM prompts), of ``recsys_ctr_batch`` and ``recsys_seq_batch`` (click
and behaviour logs for the recsys models) and of ``sbm_graph`` and
``molecule_batch`` (a stochastic-block-model graph and batches of small
graphs for the GAT) from the JAX package's ``repro.data.synthetic``,
so both packages make the same data from the same seed without the port
importing that package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def clustered_vectors(n: int, dim: int, n_clusters: int = 64,
                      scale: float = 0.35, noise_frac: float = 0.05,
                      seed: int = 0) -> np.ndarray:
    """Overlapping GMM + uniform noise floor; unit-ish norm spread."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    n_noise = int(n * noise_frac)
    asg = rng.integers(0, n_clusters, n - n_noise)
    pts = centers[asg] + scale * rng.normal(size=(n - n_noise, dim))
    noise = rng.normal(size=(n_noise, dim)) * 1.2
    out = np.concatenate([pts, noise]).astype(np.float32)
    rng.shuffle(out)
    return out


@dataclasses.dataclass(frozen=True)
class MarkovLM:
    succ: np.ndarray      # int32[V, branch] successor table
    vocab: int
    branch: int

    def entropy(self) -> float:
        return float(np.log(self.branch))


def make_markov_lm(vocab: int, branch: int = 4, seed: int = 0) -> MarkovLM:
    rng = np.random.default_rng(seed)
    succ = rng.integers(0, vocab, size=(vocab, branch)).astype(np.int32)
    return MarkovLM(succ=succ, vocab=vocab, branch=branch)


def lm_batch(lm: MarkovLM, batch: int, seq: int, step: int,
             seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """→ (tokens int32[batch, seq], targets int32[batch, seq])."""
    rng = np.random.default_rng((seed, step))
    toks = np.empty((batch, seq + 1), np.int32)
    toks[:, 0] = rng.integers(0, lm.vocab, batch)
    choices = rng.integers(0, lm.branch, size=(batch, seq))
    for t in range(seq):
        toks[:, t + 1] = lm.succ[toks[:, t], choices[:, t]]
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------------------------------
# RecSys click logs with planted latent factors
# ---------------------------------------------------------------------------

def recsys_ctr_batch(batch: int, step: int, n_dense: int = 13,
                     n_sparse: int = 26, rows: int = 1 << 21,
                     latent_dim: int = 8, seed: int = 0) -> dict:
    """CTR batch: label = σ(⟨planted user factor, planted item factor⟩)."""
    rng = np.random.default_rng((seed, step))
    dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
    sparse = rng.integers(0, rows, size=(batch, n_sparse)).astype(np.int32)
    # planted structure: hash sparse ids into latent space
    phase = (sparse[:, :latent_dim] % 97).astype(np.float32) / 97.0
    score = np.sum(np.cos(2 * np.pi * phase), axis=1) + 0.5 * dense[:, 0]
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.random(batch) < prob).astype(np.float32)
    return {"dense": dense, "sparse_ids": sparse, "label": label}


def recsys_seq_batch(batch: int, step: int, n_items: int, n_cats: int = 4096,
                     seq_len: int = 100, n_neg: int = 16,
                     n_interest_clusters: int = 128, seed: int = 0) -> dict:
    """Sequential behavior logs: each user samples from 1–3 item clusters;
    the positive target comes from one of them (retrievable structure)."""
    rng = np.random.default_rng((seed, step))
    cluster_size = max(n_items // n_interest_clusters, 1)
    user_clusters = rng.integers(0, n_interest_clusters, size=(batch, 3))
    pick = rng.integers(0, 3, size=(batch, seq_len))
    base = user_clusters[np.arange(batch)[:, None], pick]
    hist = (base * cluster_size
            + rng.integers(0, cluster_size, (batch, seq_len))).astype(np.int32)
    hist = np.minimum(hist, n_items - 1)
    lengths = rng.integers(seq_len // 2, seq_len + 1, batch)
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    tgt_cluster = user_clusters[np.arange(batch), rng.integers(0, 3, batch)]
    target = np.minimum(tgt_cluster * cluster_size
                        + rng.integers(0, cluster_size, batch),
                        n_items - 1).astype(np.int32)
    neg = rng.integers(0, n_items, size=(batch, n_neg)).astype(np.int32)
    label = rng.integers(0, 2, batch).astype(np.float32)
    return {
        "hist_items": hist,
        "hist_cats": (hist % n_cats).astype(np.int32),
        "hist_mask": mask,
        "target_item": target,
        "target_cat": (target % n_cats).astype(np.int32),
        "neg_items": neg,
        "label": label,
    }


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------

def sbm_graph(n_nodes: int, n_comms: int, d_feat: int, avg_degree: float = 4.0,
              p_in_frac: float = 0.9, seed: int = 0) -> dict:
    """Stochastic block model with community labels + noisy indicator feats."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, n_comms, n_nodes).astype(np.int32)
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    same = rng.random(n_edges) < p_in_frac
    # in-community targets: random node of the same community via rejection
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    # cheap same-community rewire: sort nodes by community, pick neighbor slots
    order = np.argsort(comm, kind="stable")
    starts = np.searchsorted(comm[order], np.arange(n_comms))
    ends = np.searchsorted(comm[order], np.arange(n_comms) + 1)
    cs = comm[src]
    lo, hi = starts[cs], np.maximum(ends[cs], starts[cs] + 1)
    in_comm = order[(lo + rng.integers(0, 1 << 30, n_edges) % np.maximum(hi - lo, 1))]
    dst = np.where(same, in_comm, dst).astype(np.int32)
    feats = (np.eye(n_comms, dtype=np.float32)[comm][:, :d_feat]
             if d_feat <= n_comms else None)
    if feats is None:
        feats = np.zeros((n_nodes, d_feat), np.float32)
        feats[np.arange(n_nodes), comm % d_feat] = 1.0
    feats = feats + 0.3 * rng.normal(size=feats.shape).astype(np.float32)
    # symmetrize
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    return {"x": feats, "src": src2.astype(np.int32),
            "dst": dst2.astype(np.int32), "labels": comm,
            "n_classes": n_comms}


def molecule_batch(batch: int, nodes_per_graph: int, edges_per_graph: int,
                   d_feat: int, n_classes: int, step: int, seed: int = 0) -> dict:
    """Block-diagonal batch of small random graphs; label = parity of a
    planted motif count (learnable)."""
    rng = np.random.default_rng((seed, step))
    N = batch * nodes_per_graph
    x = rng.normal(size=(N, d_feat)).astype(np.float32)
    src = np.concatenate([
        rng.integers(0, nodes_per_graph, edges_per_graph) + g * nodes_per_graph
        for g in range(batch)
    ]).astype(np.int32)
    dst = np.concatenate([
        rng.integers(0, nodes_per_graph, edges_per_graph) + g * nodes_per_graph
        for g in range(batch)
    ]).astype(np.int32)
    graph_ids = np.repeat(np.arange(batch), nodes_per_graph).astype(np.int32)
    feat_sum = x.reshape(batch, nodes_per_graph, d_feat).sum((1, 2))
    labels = ((feat_sum > 0).astype(np.int32)) % n_classes
    return {"x": x, "src": src, "dst": dst, "graph_ids": graph_ids,
            "labels": labels, "node_mask": np.ones(N, bool)}
