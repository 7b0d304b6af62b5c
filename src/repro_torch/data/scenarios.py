"""Non-IID client scenario registry (numpy, bit-identical to the reference's).

A scenario decides which pool samples each client holds.  Scenarios are pure
index plans over a label array, so they compose with any sample source
(``data/sources.py``).

Registered scenarios:

  ``iid``            -- uniform shuffle, equal shards.
  ``label_skew``     -- Dirichlet(alpha) label skew (``dirichlet_partition``).
  ``quantity_skew``  -- Dirichlet(alpha) sizes: IID labels, wildly different
                        sample counts; totals conserved exactly
                        (largest-remainder rounding).
  ``robot_drift``    -- per-client class mixtures that rotate across
                        ``windows`` activity windows (the paper's moving
                        robots); the dataset layer turns the per-window
                        index lists into a per-round sample-mask schedule.
  ``corpus_skew``    -- the text analogue of ``label_skew``, for the LM
                        substrate: not ported yet (ROADMAP.md Queue 1
                        item 14), it raises.

A scenario is ``fn(y, num_clients, samples_per_client, *, seed, **knobs)``
-> ``ScenarioPlan``; ``samples_per_client=None`` means the whole pool.

The bucket-width model (``bucket_widths``), its cost estimate
(``padding_waste``) and the dense-vs-packed pick (``pick_layout``) live here
too: the packed layout (``data/datasets.py``) and the engine's auto layout
share them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.data.federated import dirichlet_partition, safe_dirichlet
from repro_torch.data.sources import exhaust_choice


class ScenarioPlan(NamedTuple):
    """Index plan: per-client pool indices, plus (drift only) the per-window
    split of each client's indices, window-major; leading windows carry one
    extra sample when samples_per_client does not divide by windows."""

    client_indices: List[np.ndarray]
    window_indices: Optional[List[List[np.ndarray]]] = None


def plan_sizes(plan: ScenarioPlan) -> np.ndarray:
    """Per-client true sample counts of a plan."""
    return np.asarray([len(ci) for ci in plan.client_indices], np.int64)


def bucket_widths(counts, n_max: Optional[int] = None, *,
                  min_width: int = 16,
                  quantum: Optional[int] = None) -> np.ndarray:
    """Per-client packed widths: powers of two in sample units, or with
    ``quantum`` (the local batch size) powers of two in batch units, merged
    up to ``min_width`` and capped at the rectangle width ``n_max``."""
    counts = np.maximum(np.asarray(counts, np.int64), 1)
    if n_max is None:
        n_max = int(counts.max())
    if quantum:
        raw = quantum * 2 ** np.ceil(
            np.log2(np.maximum(-(-counts // quantum), 1))
        ).astype(np.int64)
    else:
        raw = 2 ** np.ceil(np.log2(counts)).astype(np.int64)
    return np.minimum(np.maximum(raw, min_width), n_max).astype(np.int64)


def padding_waste(counts, n_max: Optional[int] = None, *,
                  min_width: int = 16,
                  quantum: Optional[int] = None) -> dict:
    """Padded-to-real sample ratios: ``pad_to_max`` for the (N, n_max)
    rectangle, ``bucketed`` for the widths ``packed_arrays`` builds."""
    counts = np.maximum(np.asarray(counts, np.int64), 1)
    if n_max is None:
        n_max = int(counts.max())
    total = int(counts.sum())
    widths = bucket_widths(counts, n_max, min_width=min_width,
                           quantum=quantum)
    return {
        "pad_to_max": len(counts) * n_max / total,
        "bucketed": int(widths.sum()) / total,
    }


# the packed layout pays off once the rectangle wastes ~40% more padded
# compute than the buckets
LAYOUT_WASTE_THRESHOLD = 1.4


def pick_layout(counts, n_max: Optional[int] = None, *,
                min_width: int = 16, quantum: Optional[int] = None,
                threshold: float = LAYOUT_WASTE_THRESHOLD) -> str:
    """``"packed"`` when the pad-to-max waste exceeds the bucketed waste by
    ``threshold``, ``"dense"`` otherwise."""
    waste = padding_waste(counts, n_max, min_width=min_width,
                          quantum=quantum)
    ratio = waste["pad_to_max"] / max(waste["bucketed"], 1e-9)
    return "packed" if ratio >= threshold else "dense"


SCENARIOS: Dict[str, Callable] = {}


def register_scenario(name: str):
    def deco(fn):
        SCENARIOS[name] = fn
        return fn

    return deco


def make_scenario(name: str, y, num_clients: int,
                  samples_per_client: Optional[int], *, seed: int = 0,
                  **knobs) -> ScenarioPlan:
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}"
        ) from None
    return fn(np.asarray(y), num_clients, samples_per_client, seed=seed,
              **knobs)


def _draw(rng, pool_size: int, n: int) -> np.ndarray:
    return exhaust_choice(rng, np.arange(pool_size), n)


@register_scenario("iid")
def iid_scenario(y, num_clients, samples_per_client, *, seed=0):
    rng = np.random.default_rng(seed)
    if samples_per_client is None:
        idx = rng.permutation(len(y))
        return ScenarioPlan(
            [np.sort(part) for part in np.array_split(idx, num_clients)]
        )
    total = num_clients * samples_per_client
    idx = _draw(rng, len(y), total)
    return ScenarioPlan(
        [
            np.sort(idx[i * samples_per_client: (i + 1) * samples_per_client])
            for i in range(num_clients)
        ]
    )


@register_scenario("label_skew")
def label_skew_scenario(y, num_clients, samples_per_client, *, seed=0,
                        alpha=0.5):
    parts = dirichlet_partition(None, y, num_clients, alpha=alpha, seed=seed)
    if samples_per_client is None:
        return ScenarioPlan(parts)
    rng = np.random.default_rng(seed + 1)
    capped = []
    for p in parts:
        if len(p) > samples_per_client:
            p = np.sort(rng.choice(p, samples_per_client, replace=False))
        capped.append(p)
    return ScenarioPlan(capped)


@register_scenario("corpus_skew")
def corpus_skew_scenario(y, num_clients, samples_per_client, *, seed=0,
                         alpha=0.3):
    """Dirichlet(alpha) skew over per-sequence topic ids: ``label_skew``'s
    index math (a topic is a label over sequences) under the text
    scenario's own name and harsher default alpha."""
    return label_skew_scenario(
        y, num_clients, samples_per_client, seed=seed, alpha=alpha
    )


def quantity_sizes(total: int, num_clients: int, alpha: float, rng
                   ) -> np.ndarray:
    """Dirichlet(alpha) client sizes summing to ``total`` exactly
    (largest-remainder rounding); every client gets >= 1 sample whenever
    ``total >= num_clients``.  The numpy calls, the unstable default
    ``argsort`` among them, are the reference's as they are: a stable sort
    would hand ties to other clients."""
    if total < 0 or num_clients < 1:
        raise ValueError(f"bad quantity split: total={total} over "
                         f"{num_clients} clients")
    props = safe_dirichlet(rng, alpha, num_clients)
    raw = props * total
    sizes = np.floor(raw).astype(np.int64)
    short = total - sizes.sum()
    order = np.argsort(-(raw - sizes))
    sizes[order[:short]] += 1
    while total >= num_clients and (sizes == 0).any():
        sizes[np.argmax(sizes)] -= 1
        sizes[np.argmin(sizes)] += 1
    return sizes


@register_scenario("quantity_skew")
def quantity_skew_scenario(y, num_clients, samples_per_client, *, seed=0,
                           alpha=1.0):
    rng = np.random.default_rng(seed)
    total = (
        len(y) if samples_per_client is None
        else num_clients * samples_per_client
    )
    sizes = quantity_sizes(total, num_clients, alpha, rng)
    idx = (
        rng.permutation(len(y)) if samples_per_client is None
        else _draw(rng, len(y), total)
    )
    cuts = np.cumsum(sizes)[:-1]
    return ScenarioPlan([np.sort(p) for p in np.split(idx, cuts)])


@register_scenario("robot_drift")
def robot_drift_scenario(y, num_clients, samples_per_client, *, seed=0,
                         alpha=0.5, windows=4, rotate=1):
    """Client i holds ``windows`` slices; slice w is drawn from its base
    Dirichlet(alpha) class mixture rolled by ``w * rotate`` classes.  The
    engine trains round t on window ``t mod windows`` only."""
    if windows < 1:
        raise ValueError(f"robot_drift needs windows >= 1, got {windows}")
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_by_class = {c: np.where(y == c)[0] for c in classes}
    if samples_per_client is None:
        samples_per_client = len(y) // num_clients
    base_w, rem = divmod(samples_per_client, windows)
    w_counts = [base_w + (1 if w < rem else 0) for w in range(windows)]
    base = safe_dirichlet(rng, alpha, len(classes), size=num_clients)
    client_indices, window_indices = [], []
    for i in range(num_clients):
        wins = []
        for w in range(windows):
            mix = np.roll(base[i], (w * rotate) % len(classes))
            counts = rng.multinomial(w_counts[w], mix)
            picks = []
            for c, k in zip(classes, counts):
                if k == 0:
                    continue
                pool = idx_by_class[c]
                picks.append(rng.choice(pool, k, replace=len(pool) < k))
            wins.append(np.concatenate(picks) if picks else
                        np.empty(0, np.int64))
        window_indices.append(wins)
        client_indices.append(np.concatenate(wins))
    return ScenarioPlan(client_indices, window_indices)
