"""20 Newsgroups loader for the text-classification workloads (port of
``bigdl_tpu/dataset/news20.py``).  :func:`load` walks an extracted
``20news-18828``-style tree, one subdirectory a category of text files;
:func:`synthetic_news` makes a deterministic corpus of class-specific
vocabularies over shared filler words, for runs without the real one.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np


def load(folder: str) -> Tuple[List[str], np.ndarray, List[str]]:
    """Walk ``folder/<category>/<doc>`` → (texts, labels, category names),
    categories sorted for stable label ids."""
    categories = sorted(d for d in os.listdir(folder)
                        if os.path.isdir(os.path.join(folder, d)))
    texts: List[str] = []
    labels: List[int] = []
    for ix, cat in enumerate(categories):
        cdir = os.path.join(folder, cat)
        for doc in sorted(os.listdir(cdir)):
            with open(os.path.join(cdir, doc), "rb") as f:
                texts.append(f.read().decode("latin-1"))
            labels.append(ix)
    return texts, np.asarray(labels, np.int32), categories


def synthetic_news(n_docs: int = 400, n_classes: int = 4, seed: int = 0
                   ) -> Tuple[List[str], np.ndarray, List[str]]:
    """Class-specific vocabularies + shared filler words, deterministic."""
    rng = np.random.default_rng(seed)
    cats = [f"topic{i}" for i in range(n_classes)]
    vocab = {c: [f"{c}_w{j}" for j in range(30)] for c in cats}
    shared = [f"common{j}" for j in range(30)]
    texts, labels = [], []
    for _ in range(n_docs):
        y = int(rng.integers(0, n_classes))
        n = int(rng.integers(20, 60))
        words = rng.choice(vocab[cats[y]] + shared, size=n)
        texts.append(" ".join(words))
        labels.append(y)
    return texts, np.asarray(labels, np.int32), cats
