"""Text pipeline (port of ``bigdl_tpu/dataset/text.py``): tokenizers,
``Dictionary``, the sentence transformers and the PTB corpus reader.

Host-side numpy, as in the reference, so the data order and every id
equal the reference's bitwise.  Fixed-length padding and truncation
happen here, so that every batch of a run has one shape.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

SENTENCE_START = "SENTENCE_START"
SENTENCE_END = "SENTENCE_END"


def sentence_splitter(text: str) -> List[str]:
    """Running text split into sentences after ``.``, ``!`` or ``?``."""
    parts = re.split(r"(?<=[.!?])\s+", text.strip())
    return [p for p in parts if p]


def sentence_tokenizer(sentence: str) -> List[str]:
    """One sentence, lower-cased, as words, numbers and single
    punctuation marks."""
    return re.findall(r"[\w']+|[^\w\s]", sentence.lower())


class SentenceTokenizer(Transformer):
    """str -> List[str] (:func:`sentence_tokenizer`)."""

    def __call__(self, it: Iterator[str]) -> Iterator[List[str]]:
        return (sentence_tokenizer(s) for s in it)


class SentenceBiPadding(Transformer):
    """Wrap each token list in ``SENTENCE_START`` / ``SENTENCE_END``."""

    def __call__(self, it):
        for toks in it:
            yield [SENTENCE_START] + list(toks) + [SENTENCE_END]


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

    def save(self, path: str) -> None:
        """One word a line, in index order (the reference's file)."""
        with open(path, "w") as f:
            for w in self.index2word:
                f.write(w + "\n")

    @staticmethod
    def load(path: str) -> "Dictionary":
        d = Dictionary()
        with open(path) as f:
            for line in f:
                w = line.rstrip("\n")
                d.word2index[w] = len(d.index2word)
                d.index2word.append(w)
        return d


class LabeledSentence:
    """A (data ids, label ids) pair, int32."""

    __slots__ = ("data", "label")

    def __init__(self, data, label):
        self.data = np.asarray(data, np.int32)
        self.label = np.asarray(label, np.int32)


class TextToLabeledSentence(Transformer):
    """The language model's shift: data ``tokens[:-1]``, label
    ``tokens[1:]``, as ids of ``dictionary``; sentences of fewer than two
    tokens are dropped."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, it):
        for toks in it:
            ids = self.dictionary.encode(toks)
            if len(ids) < 2:
                continue
            yield LabeledSentence(ids[:-1], ids[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample of ``fixed_length`` steps, padded with
    ``padding_value`` or truncated; with ``one_hot`` the feature is the
    (fixed_length, vocab_size) f32 one-hot rows of the ids."""

    def __init__(self, fixed_length: int, padding_value: int = 0,
                 one_hot: bool = False, vocab_size: Optional[int] = None):
        self.fixed_length = fixed_length
        self.padding_value = padding_value
        self.one_hot = one_hot
        self.vocab_size = vocab_size

    def _fix(self, ids: np.ndarray) -> np.ndarray:
        L = self.fixed_length
        if len(ids) >= L:
            return ids[:L]
        pad = np.full(L - len(ids), self.padding_value, np.int32)
        return np.concatenate([ids, pad])

    def __call__(self, it):
        for ls in it:
            data = self._fix(ls.data)
            label = self._fix(ls.label)
            if self.one_hot:
                data = np.eye(self.vocab_size, dtype=np.float32)[data]
            yield Sample(data, label)


# --------------------------------------------------------------- PTB corpus
def read_ptb_words(path: str) -> List[str]:
    """A PTB-format file (one sentence a line) as one word stream, each
    line ended by ``<eos>``."""
    words: List[str] = []
    with open(path) as f:
        for line in f:
            words.extend(line.split())
            words.append("<eos>")
    return words


def ptb_batches(word_ids: np.ndarray, num_steps: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous (data, label) windows of ``num_steps`` ids, the label
    the data shifted by one."""
    n = (len(word_ids) - 1) // num_steps
    x = word_ids[:n * num_steps].reshape(n, num_steps)
    y = word_ids[1:n * num_steps + 1].reshape(n, num_steps)
    return x, y


def synthetic_corpus(n_sentences: int = 200, seed: int = 0) -> List[str]:
    """Sentences of 4-11 words over 50 words of Zipf-like frequency, each
    ended by " ."; the same as the reference's for the same seed."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(50)]
    probs = 1.0 / np.arange(1, 51)
    probs /= probs.sum()
    out = []
    for _ in range(n_sentences):
        n = int(rng.integers(4, 12))
        out.append(" ".join(rng.choice(vocab, size=n, p=probs)) + " .")
    return out
