"""MovieLens ratings loader for the recommender recipes (port of
``bigdl_tpu/dataset/movielens.py``): parses ``ml-1m/ratings.dat``'s
``user::item::rating::timestamp`` lines.  Nothing is downloaded; point
:func:`load` at an extracted tree or use :func:`synthetic_ratings`.
"""

from __future__ import annotations

import os

import numpy as np


def load(folder: str, filename: str = "ratings.dat") -> np.ndarray:
    """Return an int array (N, 3) of [user, item, rating] (1-based ids,
    like the reference's parser)."""
    path = os.path.join(folder, filename)
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("::")
            if len(parts) >= 3:
                out.append((int(parts[0]), int(parts[1]),
                            int(float(parts[2]))))
    return np.asarray(out, np.int32)


def synthetic_ratings(n_users: int = 200, n_items: int = 100,
                      n_ratings: int = 5000, seed: int = 0) -> np.ndarray:
    """Deterministic synthetic ratings with real structure: each user has
    a latent preference vector, so NCF-style models can actually fit."""
    rng = np.random.default_rng(seed)
    u_lat = rng.normal(0, 1, (n_users, 4))
    i_lat = rng.normal(0, 1, (n_items, 4))
    users = rng.integers(0, n_users, n_ratings)
    items = rng.integers(0, n_items, n_ratings)
    score = (u_lat[users] * i_lat[items]).sum(1)
    rating = np.clip(np.round(3 + score), 1, 5).astype(np.int32)
    return np.stack([users + 1, items + 1, rating], axis=1).astype(np.int32)


def to_implicit_samples(ratings: np.ndarray, threshold: int = 4):
    """[user, item, rating] → Samples of ((user, item), clicked) for the
    NCF binary objective (reference NCF example preprocessing)."""
    from bigdl_tpu_torch.dataset.sample import Sample
    return [Sample(np.asarray([r[0] - 1, r[1] - 1], np.int32),
                   np.int32(1 if r[2] >= threshold else 0))
            for r in ratings]
