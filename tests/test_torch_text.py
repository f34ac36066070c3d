"""The text pipeline and ragged batching of the port on the CPU against
the reference, and the two text recipes at small widths.

- Bitwise against ``bigdl_tpu.dataset.text``: ``sentence_splitter``,
  ``sentence_tokenizer``, ``SentenceTokenizer`` >> ``SentenceBiPadding``,
  ``Dictionary`` (index order, ``encode``, ``save``/``load`` across the two
  packages), ``read_ptb_words`` on a file the test writes,
  ``ptb_batches``, ``TextToLabeledSentence``, ``LabeledSentenceToSample``
  with and without ``one_hot``, ``synthetic_corpus``.
- ``PaddingParam`` (longest, ``fixed_length``, ``buckets``) through
  ``batch_samples`` and ``SampleToMiniBatch``, bitwise against the
  reference, and its errors.
- ``examples/rnn/train.py``'s recipe through the text pipeline (the PTB
  LSTM model and the one-hot SimpleRNN chain) and
  ``examples/textclassification/train.py``'s text CNN, at small widths
  (hidden 16), a few Adam steps through ``LocalOptimizer`` against the
  reference's from the same weights on the same batches: each step's loss
  within ``rtol=1e-5`` and every trained weight within ``2e-3`` of its
  array's largest value (Adam's first steps move a weight by about lr
  times the sign of its gradient, so a gradient within rounding of 0 moves
  it differently in the two packages; the losses hold the rest).
- ``chip_smoke.py``'s copy of the text CNN example's corpus equals the
  example's.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu import optim as joptim  # noqa: E402
from bigdl_tpu.dataset import DataSet as JDataSet  # noqa: E402
from bigdl_tpu.dataset import PaddingParam as JPaddingParam  # noqa: E402
from bigdl_tpu.dataset import SampleToMiniBatch as JSampleToMiniBatch  # noqa: E402
from bigdl_tpu.dataset import batch_samples as jbatch_samples  # noqa: E402
from bigdl_tpu.dataset import text as jtext  # noqa: E402
from bigdl_tpu.dataset.sample import Sample as JSample  # noqa: E402
from bigdl_tpu.models.rnn import ptb_model as jax_ptb_model  # noqa: E402
from bigdl_tpu.models.rnn import simple_rnn as jax_simple_rnn  # noqa: E402
from bigdl_tpu_torch import nn, optim  # noqa: E402
from bigdl_tpu_torch.dataset import (DataSet, PaddingParam, Sample,  # noqa: E402
                                     SampleToMiniBatch, batch_samples, text)
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import ptb_model, simple_rnn  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNING = ("It's a test.  Numbers like 3.5 and 42 stay! Does it split? "
           "Yes: commas, semi-colons; and \"quotes\" too.")


def test_tokenizers_match_reference():
    assert text.sentence_splitter(RUNNING) == jtext.sentence_splitter(RUNNING)
    for s in text.sentence_splitter(RUNNING) + ["", "A-b c_d"]:
        assert text.sentence_tokenizer(s) == jtext.sentence_tokenizer(s)
    lines = jtext.synthetic_corpus(20, seed=4) + [RUNNING]
    got = list(text.SentenceBiPadding()(text.SentenceTokenizer()(
        iter(lines))))
    want = list(jtext.SentenceBiPadding()(jtext.SentenceTokenizer()(
        iter(lines))))
    assert got == want
    assert got[0][0] == text.SENTENCE_START == jtext.SENTENCE_START
    assert got[0][-1] == text.SENTENCE_END == jtext.SENTENCE_END


def test_synthetic_corpus_matches_reference():
    for n, seed in ((200, 0), (37, 5)):
        assert text.synthetic_corpus(n, seed) == \
            jtext.synthetic_corpus(n, seed)


@pytest.mark.parametrize("vocab_size", [None, 10, 60])
def test_dictionary_matches_reference(vocab_size, tmp_path):
    sents = [text.sentence_tokenizer(s)
             for s in text.synthetic_corpus(120, seed=1)]
    d = text.Dictionary(sents, vocab_size=vocab_size)
    jd = jtext.Dictionary(sents, vocab_size=vocab_size)
    assert d.index2word == jd.index2word
    assert d.word2index == jd.word2index
    assert d.vocab_size() == jd.vocab_size()
    toks = sents[3] + ["never-seen"]
    np.testing.assert_array_equal(d.encode(toks), jd.encode(toks))
    assert d.encode(toks).dtype == np.int32
    d.save(tmp_path / "port.txt")
    jd.save(tmp_path / "ref.txt")
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    back = text.Dictionary.load(tmp_path / "ref.txt")
    assert back.index2word == jd.index2word
    assert jtext.Dictionary.load(tmp_path / "port.txt").word2index == \
        d.word2index


def _write_ptb(path, n_lines=60, seed=2):
    rng = np.random.default_rng(seed)
    words = ["the", "<unk>", "n", "of", "a", "market", "said"]
    with open(path, "w") as f:
        for _ in range(n_lines):
            f.write(" " + " ".join(rng.choice(words, rng.integers(3, 9)))
                    + " \n")


def test_ptb_reader_and_batches_match_reference(tmp_path):
    path = tmp_path / "ptb.train.txt"
    _write_ptb(path)
    words = text.read_ptb_words(path)
    assert words == jtext.read_ptb_words(path)
    assert words.count("<eos>") == 60
    d = text.Dictionary([words], vocab_size=5)
    ids = d.encode(words)
    for steps in (5, 7):
        got, want = text.ptb_batches(ids, steps), jtext.ptb_batches(ids,
                                                                    steps)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])


@pytest.mark.parametrize("one_hot", [False, True])
def test_labeled_sentences_match_reference(one_hot):
    lines = text.synthetic_corpus(30, seed=3) + ["short"]
    toks = list(text.SentenceBiPadding()(text.SentenceTokenizer()(
        iter(lines))))
    d = text.Dictionary(toks, vocab_size=20)
    kw = dict(one_hot=one_hot, vocab_size=d.vocab_size())
    got = list(text.LabeledSentenceToSample(8, 3, **kw)(
        text.TextToLabeledSentence(d)(iter(toks + [["x"]]))))
    want = list(jtext.LabeledSentenceToSample(8, 3, **kw)(
        jtext.TextToLabeledSentence(jtext.Dictionary(toks, 20))(
            iter(toks + [["x"]]))))
    assert len(got) == len(want) == len(toks)  # ["x"] is dropped
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        np.testing.assert_array_equal(g.label, w.label)
        assert g.feature.dtype == w.feature.dtype
        assert g.feature.shape == ((8, d.vocab_size()) if one_hot else (8,))


def _ragged(n, width=None, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(2, 7))
        f = rng.normal(size=(L, width) if width else L).astype(np.float32)
        out.append((f, rng.integers(0, 9, L).astype(np.int32)))
    return out


@pytest.mark.parametrize("feature, label", [
    (dict(), dict(padding_value=-1)),
    (dict(padding_value=0.5, fixed_length=9), dict(fixed_length=9)),
    (dict(buckets=(4, 8, 16)), dict(padding_value=7, buckets=(5, 10))),
])
def test_padding_param_matches_reference(feature, label):
    pairs = _ragged(5, width=3)
    got = batch_samples([Sample(f, y) for f, y in pairs],
                        PaddingParam(**feature), PaddingParam(**label))
    want = jbatch_samples([JSample(f, y) for f, y in pairs],
                          JPaddingParam(**feature), JPaddingParam(**label))
    for g, w in ((got.input, want.input), (got.target, want.target)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    # through the transformer, a batch of 2 and the kept remainder
    samples = [Sample(f, y) for f, y in pairs]
    jsamples = [JSample(f, y) for f, y in pairs]
    mk = dict(feature_padding=PaddingParam(**feature),
              label_padding=PaddingParam(**label), drop_remainder=False)
    jmk = dict(feature_padding=JPaddingParam(**feature),
               label_padding=JPaddingParam(**label), drop_remainder=False)
    got = list(SampleToMiniBatch(2, **mk)(iter(samples)))
    want = list(JSampleToMiniBatch(2, **jmk)(iter(jsamples)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.input, w.input)
        np.testing.assert_array_equal(g.target, w.target)


def test_padding_param_errors():
    samples = [Sample(f, y) for f, y in _ragged(4)]
    with pytest.raises(ValueError, match="need a PaddingParam"):
        batch_samples(samples)
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        batch_samples(samples, PaddingParam(buckets=(2, 3)),
                      PaddingParam())
    even = [Sample(np.ones(3, np.float32), np.int32(1))] * 2
    np.testing.assert_array_equal(batch_samples(even).input,
                                  np.ones((2, 3), np.float32))


# ------------------------------------------------------------ the recipes
def _recording(cls):
    class Recording(cls):
        def _log_train_iteration(self, lr):
            self.losses = getattr(self, "losses", []) + [self.state["loss"]]
    return Recording


def _flat(tree, prefix=""):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(v)
    return out


def _train_both(model, jmodel, samples, jsamples, criterion, jcriterion,
                batch, lr, steps):
    """The port's and the reference's LocalOptimizer from the port's
    initial weights: (port losses, reference losses, port weights,
    reference weights)."""
    params, state = to_jax_params(model)
    jmodel._params = jax.tree_util.tree_map(jnp.asarray, params)
    jmodel._state = jax.tree_util.tree_map(jnp.asarray, state)
    opt = (_recording(optim.LocalOptimizer)(
        model, DataSet.array(samples, seed=3) >> SampleToMiniBatch(batch),
        criterion, device="cpu")
        .set_optim_method(optim.Adam(learning_rate=lr))
        .set_end_when(optim.max_iteration(steps)))
    opt.optimize()
    jopt = (_recording(joptim.LocalOptimizer)(
        jmodel, JDataSet.array(jsamples, seed=3)
        >> JSampleToMiniBatch(batch), jcriterion)
        .set_optim_method(joptim.Adam(learning_rate=lr))
        .set_end_when(joptim.max_iteration(steps)))
    jopt.optimize()
    return (opt.losses, jopt.losses, _flat(to_jax_params(model)[0]),
            _flat(jax.tree_util.tree_map(np.asarray, jmodel._params)))


def _assert_training_close(got, want, got_w, want_w, steps):
    assert len(got) == len(want) == steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got_w.keys() == want_w.keys()
    for k, w in want_w.items():
        np.testing.assert_allclose(got_w[k], w, rtol=0,
                                   atol=2e-3 * np.abs(w).max(), err_msg=k)
    assert np.mean(got[-2:]) < np.mean(got[:2])


def test_ptb_recipe_through_text_pipeline_matches_reference():
    """``examples/rnn/train.py`` without ``-f``: the synthetic corpus,
    tokenized, a Dictionary over its words, ``ptb_batches`` of 20 steps,
    batch 20, ``ptb_model`` at hidden 16, Adam lr 0.005,
    ``TimeDistributedCriterion(ClassNLLCriterion(), size_average=True)``."""
    sents = [text.sentence_tokenizer(s) for s in text.synthetic_corpus(400)]
    words = [w for s in sents for w in s]
    d = text.Dictionary([words], vocab_size=10000)
    x, y = text.ptb_batches(d.encode(words), 20)
    V = d.vocab_size()
    model = ptb_model(V, 16, 16).initialize(0)
    got = _train_both(
        model, jax_ptb_model(V, 16, 16),
        [Sample(a, b) for a, b in zip(x, y)],
        [JSample(a, b) for a, b in zip(x, y)],
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                    size_average=True),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                     size_average=True), 20, 0.005, 6)
    _assert_training_close(*got, 6)


def test_simple_rnn_one_hot_chain_matches_reference():
    """The one-hot chain for ``simple_rnn`` (``SentenceTokenizer`` >>
    ``SentenceBiPadding``, a Dictionary, ``TextToLabeledSentence`` >>
    ``LabeledSentenceToSample(one_hot=True)``), hidden 16."""
    lines = text.synthetic_corpus(200, seed=1)
    toks = list(text.SentenceBiPadding()(text.SentenceTokenizer()(
        iter(lines))))
    d = text.Dictionary(toks, vocab_size=30)
    V = d.vocab_size()
    samples = list(text.LabeledSentenceToSample(
        10, one_hot=True, vocab_size=V)(text.TextToLabeledSentence(d)(
            iter(toks))))
    model = simple_rnn(V, 16, V).initialize(0)
    got = _train_both(
        model, jax_simple_rnn(V, 16, V), samples,
        [JSample(s.feature, s.label) for s in samples],
        nn.TimeDistributedCriterion(nn.ClassNLLCriterion(),
                                    size_average=True),
        jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion(),
                                     size_average=True), 20, 0.005, 6)
    _assert_training_close(*got, 6)


def _load_example(rel):
    spec = importlib.util.spec_from_file_location(
        "example_" + rel.replace("/", "_")[:-3], os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_copies_the_text_cnn_corpus():
    import chip_smoke
    example = _load_example("examples/textclassification/train.py")
    for n, seed in ((400, 0), (50, 3)):
        assert chip_smoke.text_cnn_corpus(n, seed) == \
            example.synthetic_corpus(n, seed)


def test_text_cnn_recipe_matches_reference():
    """``examples/textclassification/train.py`` at its widths but for the
    embedding (16): LookupTable >> TemporalConvolution(16, 64, 3) >> ReLU
    >> max over time (``amax`` here, ``max(axis=1)`` there) >> Linear >>
    LogSoftMax, ClassNLL, Adam lr 0.01, batch 32."""
    import chip_smoke
    samples, V = chip_smoke.text_cnn_samples(*chip_smoke.text_cnn_corpus(),
                                             seq_len=12)
    model = chip_smoke.text_cnn(V, 16).initialize(0)
    jmodel = (jnn.Sequential()
              .add(jnn.LookupTable(V, 16))
              .add(jnn.TemporalConvolution(16, 64, 3))
              .add(jnn.ReLU())
              .add(jnn.Lambda(lambda x: x.max(axis=1)))
              .add(jnn.Linear(64, 2))
              .add(jnn.LogSoftMax()))
    got = _train_both(model, jmodel, samples,
                      [JSample(s.feature, s.label) for s in samples],
                      nn.ClassNLLCriterion(), jnn.ClassNLLCriterion(), 32,
                      0.01, 8)
    _assert_training_close(*got, 8)


def test_lambda_text_cnn_takes_tied_maxima_like_reference():
    """Padding windows give the max over time many tied positions: the
    port's ``amax`` shares their gradient as the reference's ``max`` does,
    so one step's embedding gradient agrees."""
    import chip_smoke
    samples, V = chip_smoke.text_cnn_samples(*chip_smoke.text_cnn_corpus(8),
                                             seq_len=30)
    model = chip_smoke.text_cnn(V, 8).initialize(1)
    params, state = to_jax_params(model)
    x = np.stack([s.feature for s in samples])
    jmodel = (jnn.Sequential().add(jnn.LookupTable(V, 8))
              .add(jnn.TemporalConvolution(8, 64, 3)).add(jnn.ReLU())
              .add(jnn.Lambda(lambda a: a.max(axis=1)))
              .add(jnn.Linear(64, 2)).add(jnn.LogSoftMax()))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = jax.grad(lambda p: jmodel.apply(p, state, jnp.asarray(x))[0]
                    .sum())(jp)
    for p in model.parameters():
        p.requires_grad_(True)
    model(torch.from_numpy(x)).sum().backward()
    got = dict(model.named_parameters())
    for k, w in _flat(jax.tree_util.tree_map(np.asarray, want)).items():
        np.testing.assert_allclose(got[k].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
