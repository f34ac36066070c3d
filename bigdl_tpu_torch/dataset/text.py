"""Text vocabulary (port of ``Dictionary`` from ``bigdl_tpu/dataset/text.py``)."""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class Dictionary:
    """Word <-> index maps over the ``vocab_size`` most frequent words
    (ties in first-seen order); every other word maps to an unknown token
    appended at the end."""

    UNKNOWN = "<unk>"

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self.word2index: Dict[str, int] = {}
        self.index2word: List[str] = []
        if sentences is not None:
            counts = Counter(w for s in sentences for w in s)
            for w, _ in counts.most_common(vocab_size):
                self.word2index[w] = len(self.index2word)
                self.index2word.append(w)
            if self.UNKNOWN not in self.word2index:
                self.word2index[self.UNKNOWN] = len(self.index2word)
                self.index2word.append(self.UNKNOWN)

    def vocab_size(self) -> int:
        return len(self.index2word)

    def index(self, word: str) -> int:
        return self.word2index.get(word, self.word2index[self.UNKNOWN])

    def word(self, ix: int) -> str:
        return self.index2word[ix]

    def encode(self, tokens: Sequence[str]) -> np.ndarray:
        return np.asarray([self.index(w) for w in tokens], np.int32)
