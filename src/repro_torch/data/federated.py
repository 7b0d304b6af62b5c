"""Federated fleets and partitions (numpy, bit-identical to the reference
builders).

``table2_fleet`` reproduces the paper's Table II: 12 robots, per-robot
label subsets / sample counts / activation functions, with the two
poisoners label-flipping.  ``scaled_fleet`` tiles Table II out to any fleet
size for engine-scale runs; ``sybil_fleet`` adds a replica sybil clique to
the tiled fleet.  All three take an optional sample ``source``
(``data/sources.py``; the synthetic generator by default).
``dirichlet_partition`` is the non-IID label splitter the scenarios use.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.resources import POISON_FRAC
from repro_torch.data.sources import DigitSource, SyntheticSource

# Table II: (labels, activation, n_samples); softmax=1, relu=0
TABLE_II = [
    (list(range(10)), 1, 1000),  # Robot 1
    (list(range(10)), 0, 1000),  # Robot 2
    ([0, 1, 2, 3], 1, 400),  # Robot 3  (resource-starved)
    (list(range(10)), 1, 1000),  # Robot 4
    ([4, 5, 6], 0, 300),  # Robot 5  (resource-starved)
    ([7, 8, 9], 0, 300),  # Robot 6  (unreliable)
    (list(range(10)), 1, 1000),  # Robot 7
    (list(range(10)), 0, 1000),  # Robot 8
    ([5, 6, 8], 1, 300),  # Robot 9  (unreliable)
    (list(range(10)), 1, 1000),  # Robot 10
    (list(range(10)), 0, 1000),  # Robot 11
    (list(range(10)), 1, 1000),  # Robot 12
]


def _build_fleet(profiles, poisoners, *, flip_frac: float, seed: int,
                 samples_per_client: int | None,
                 source: DigitSource | None = None):
    """Stack per-client digit shards for a list of (labels, act, n)
    profiles, padded to the max sample count by wrap-around so the client
    block is rectangular; ``sizes`` holds the real n_u."""
    src = source if source is not None else SyntheticSource()
    xs, ys, sizes, acts = [], [], [], []
    n_max = 0
    for i, (labels, act, n) in enumerate(profiles):
        if samples_per_client:
            n = min(n, samples_per_client)
        flip = flip_frac if i in poisoners else 0.0
        x, y = src.sample(n, labels, seed=seed * 101 + i, flip_frac=flip)
        xs.append(x)
        ys.append(y)
        sizes.append(n)
        acts.append(act)
        n_max = max(n_max, n)
    for i in range(len(xs)):
        n = xs[i].shape[0]
        if n < n_max:
            reps = int(np.ceil(n_max / n))
            xs[i] = np.tile(xs[i], (reps, 1))[:n_max]
            ys[i] = np.tile(ys[i], reps)[:n_max]
    return {
        "x": np.stack(xs),
        "y": np.stack(ys),
        "sizes": np.asarray(sizes, np.float32),
        "activations": np.asarray(acts, np.int32),
    }


def table2_fleet(*, seed: int = 0, poisoners=(10, 11), flip_frac: float = 0.6,
                 samples_per_client: int | None = None,
                 source: DigitSource | None = None):
    """The paper's exact 12-robot fleet (Table II); ``poisoners`` are
    0-indexed robots whose labels are flipped, ``samples_per_client`` caps
    the Table II counts."""
    return _build_fleet(TABLE_II, set(poisoners), flip_frac=flip_frac,
                        seed=seed, samples_per_client=samples_per_client,
                        source=source)


def scaled_fleet(num_clients: int, *, seed: int = 0,
                 num_poisoners: int | None = None,
                 poison_frac: float = POISON_FRAC, flip_frac: float = 0.6,
                 samples_per_client: int | None = 200,
                 return_poisoners: bool = False,
                 source: DigitSource | None = None):
    """Table II tiled out to ``num_clients`` robots: client ``i`` inherits
    profile ``TABLE_II[i % 12]`` and the LAST ``num_poisoners`` clients
    label-flip (the poisoner positions of ``resources.make_fleet``)."""
    if num_poisoners is None:
        num_poisoners = int(round(num_clients * poison_frac))
    profiles = [TABLE_II[i % len(TABLE_II)] for i in range(num_clients)]
    poisoners = set(range(num_clients - num_poisoners, num_clients))
    data = _build_fleet(profiles, poisoners, flip_frac=flip_frac, seed=seed,
                        samples_per_client=samples_per_client, source=source)
    if return_poisoners:
        mask = np.zeros(num_clients, bool)
        mask[list(poisoners)] = True
        return data, mask
    return data


def sybil_fleet(num_clients: int, num_sybils: int, *, seed: int = 0,
                samples_per_client: int = 200, flip_frac: float = 1.0,
                target_shift: int = 1, source: DigitSource | None = None):
    """The tiled honest fleet plus a replica sybil clique (the FoolsGold
    threat model of Fung et al.): the last ``num_sybils`` clients all hold
    the same poisoned shard, one dataset with labels shifted ``y -> (y +
    target_shift) % 10`` on ``flip_frac`` of its samples, so they push one
    objective and their updates are near-identical.

    Returns (data dict, (num_clients,) bool sybil mask)."""
    src = source if source is not None else SyntheticSource()
    profiles = [TABLE_II[i % len(TABLE_II)] for i in range(num_clients)]
    data = _build_fleet(profiles, set(), flip_frac=0.0, seed=seed,
                        samples_per_client=samples_per_client, source=src)
    mask = np.zeros(num_clients, bool)
    if num_sybils:
        mask[num_clients - num_sybils:] = True
        n = data["x"].shape[1]
        x, y = src.sample(n, seed=seed * 101 + 999)
        k = int(n * flip_frac)
        idx = np.random.default_rng(seed + 7).choice(n, k, replace=False)
        y[idx] = (y[idx] + target_shift) % 10
        for i in np.where(mask)[0]:
            data["x"][i] = x
            data["y"][i] = y
            data["activations"][i] = 1
            data["sizes"][i] = n
    return data, mask


def safe_dirichlet(rng, alpha: float, n: int, size=None) -> np.ndarray:
    """Dirichlet(alpha) draw(s) guarded against alpha underflow: a row whose
    gamma draws underflow to all-zero (NaN after normalization) becomes the
    alpha -> 0 limit, all mass on one uniformly drawn entry.  The RNG stream
    matches a bare ``rng.dirichlet`` call when no row underflows."""
    props = rng.dirichlet([alpha] * n, size=size)
    rows = props.reshape(-1, n)  # contiguous view: writes land in props
    for i in np.where(~np.isfinite(rows).all(axis=1))[0]:
        rows[i] = 0.0
        rows[i, rng.integers(n)] = 1.0
    return props


def dirichlet_partition(x, y, num_clients: int, alpha: float = 0.5,
                        seed: int = 0):
    """Non-IID label-Dirichlet split -> list of sorted index arrays.
    ``num_clients`` must be in [1, len(y)] and ``alpha`` positive and
    finite; an underflowing alpha falls back to a one-hot assignment
    (``safe_dirichlet``)."""
    y = np.asarray(y)
    if num_clients < 1:
        raise ValueError(f"num_clients must be >= 1, got {num_clients}")
    if not np.isfinite(alpha) or alpha <= 0:
        raise ValueError(f"alpha must be a positive finite float, got {alpha}")
    if y.size == 0:
        raise ValueError("cannot partition an empty label array")
    if num_clients > y.size:
        raise ValueError(
            f"num_clients={num_clients} exceeds the {y.size} samples: "
            "every split would contain empty shards"
        )
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    idx_by_class = [np.where(y == c)[0] for c in classes]
    client_idx = [[] for _ in range(num_clients)]
    for idxs in idx_by_class:
        rng.shuffle(idxs)
        props = safe_dirichlet(rng, alpha, num_clients)
        cuts = (np.cumsum(props) * len(idxs)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idxs, cuts)):
            client_idx[cid].extend(part.tolist())
    return [np.asarray(sorted(ci), dtype=np.int64) for ci in client_idx]
