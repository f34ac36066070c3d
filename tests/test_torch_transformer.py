"""The port's attention layers, ``transformer_lm`` and its KV-cache decode
carry against the reference (``bigdl_tpu/nn/attention.py``,
``bigdl_tpu/models/transformer.py``) with one numpy parameter set, 2
layers, embed 32, vocab 64, f32 on the CPU.

Tolerances: forwards, prefill and every decode step within 1e-5 of the
reference's log-probs (sound readings ~1e-6, both packages computing the
same f32 ops in another order); the cached decode within 1e-5 of the
full-context forward inside the port.  Three planted faults (``wq``
transposed, the decode step's position off by one, the causal cut at
``<`` in place of ``<=``) must read above ``FAULT_FLOOR`` (they read
1.80, 4.81 and 2.21 against a sound 9.5e-07), which puts the limit between them and the sound reading.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu.models import transformer as jtr  # noqa: E402
from bigdl_tpu.nn import attention as jatt  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params, to_jax_params  # noqa: E402
from bigdl_tpu_torch.models import transformer as tr  # noqa: E402
from bigdl_tpu_torch.nn import attention as att  # noqa: E402

VOCAB, EMBED, HEADS, LAYERS, MAX_LEN = 64, 32, 4, 2, 64
TOL = 1e-5
FAULT_FLOOR = 1e-2
DATA_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "data")


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def pair():
    """(port lm, reference lm, reference params) from one seed."""
    m = tr.transformer_lm(VOCAB, EMBED, HEADS, LAYERS,
                          max_len=MAX_LEN).initialize(0).eval()
    params, _ = to_jax_params(m)
    jm = jtr.transformer_lm(VOCAB, EMBED, HEADS, LAYERS, max_len=MAX_LEN)
    return m, jm, jtree(params)


def tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, shape) \
        .astype(np.int32)


def err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    w, b = rng.uniform(0.5, 1.5, 8), rng.normal(0, 0.2, 8)
    x = rng.normal(0, 2, (3, 5, 8)).astype(np.float32)
    ln = att.LayerNorm(8)
    load_jax_params(ln, {"weight": w.astype(np.float32),
                         "bias": b.astype(np.float32)})
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    y = ln(xt)
    jy, _ = jatt.LayerNorm(8).apply(
        {"weight": jnp.asarray(w, jnp.float32),
         "bias": jnp.asarray(b, jnp.float32)}, {},
        jnp.asarray(x).astype(dtype))
    assert y.dtype == xt.dtype
    assert err(y.float().numpy(), np.asarray(jy, np.float32)) <= \
        (1e-6 if dtype == "float32" else 1e-2)


def _mha_params(D, seed):
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(0, 0.3, (D, D)).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    p.update({k: rng.normal(0, 0.1, (D,)).astype(np.float32)
              for k in ("bq", "bk", "bv", "bo")})
    return p


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_multi_head_attention_matches_reference(causal, cross):
    D, H = 16, 4
    p = _mha_params(D, 2)
    rng = np.random.default_rng(3)
    xq = rng.normal(0, 1, (2, 5, D)).astype(np.float32)
    xkv = rng.normal(0, 1, (2, 7 if cross else 5, D)).astype(np.float32)
    mha = load_jax_params(att.MultiHeadAttention(D, H, causal=causal), p)
    inp = (torch.from_numpy(xq), torch.from_numpy(xkv)) if cross \
        else torch.from_numpy(xq)
    jinp = (jnp.asarray(xq), jnp.asarray(xkv)) if cross \
        else jnp.asarray(xq)
    jy, _ = jatt.MultiHeadAttention(D, H, causal=causal).apply(
        jtree(p), {}, jinp)
    assert err(mha(inp).detach().numpy(), jy) <= TOL


def test_dot_product_attention_mask_matches_reference():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(0, 1, (2, 3, 4, 8)).astype(np.float32)
               for _ in range(3))
    mask = rng.random((2, 1, 4, 4)) < 0.7
    mask[..., 0] = True  # no row fully masked (the reference gives NaN)
    y = att.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                  mask=torch.from_numpy(mask))
    jy = jatt.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                    mask=jnp.asarray(mask))
    assert err(y.numpy(), jy) <= TOL


def test_fully_masked_row_is_zero_not_nan():
    q = k = v = torch.ones(1, 1, 2, 4)
    mask = torch.tensor([[True, False], [False, False]])
    y = att.dot_product_attention(q, k, v, mask=mask)
    assert torch.isfinite(y).all()
    assert torch.equal(y[0, 0, 1], torch.zeros(4))
    assert torch.equal(y[0, 0, 0], torch.ones(4))


@pytest.mark.parametrize("name", ["multi_head_attention",
                                  "multi_head_attention_causal",
                                  "layer_norm"])
def test_golden_fixture(name):
    """The torch-float64 golden fixtures (``generate_fixtures.py``; the
    MHA oracle is ``F.multi_head_attention_forward``): forward, input
    and parameter gradients within rtol 2e-4 / atol 2e-5."""
    z = np.load(os.path.join(DATA_DIR, f"{name}.npz"))
    model = att.LayerNorm(8) if name == "layer_norm" else \
        att.MultiHeadAttention(8, 2, causal=name.endswith("causal"))
    params = dict(model.named_parameters())
    keys = [k[2:] for k in z.files if k.startswith("p_")]
    with torch.no_grad():
        for k in keys:
            params[k].copy_(torch.from_numpy(z[f"p_{k}"].astype(np.float32)))
            params[k].requires_grad_(True)
    x = torch.from_numpy(z["x"].astype(np.float32)).requires_grad_(True)
    out = model(x)
    out.sum().backward()
    tol = dict(rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out.detach().numpy(), z["out"], **tol)
    np.testing.assert_allclose(x.grad.numpy(), z["dx"], **tol)
    for k in keys:
        np.testing.assert_allclose(params[k].grad.numpy(), z[f"dp_{k}"],
                                   **tol, err_msg=k)


# ------------------------------------------------------------ the model
def test_tree_layout_is_the_references():
    """The port's tree has the reference's leaf names and shapes, and the
    reference's own initial weights load into the port and give its
    forward."""
    jm = jtr.transformer_lm(VOCAB, EMBED, HEADS, LAYERS, max_len=MAX_LEN)
    jp, js = jm.init(jax.random.PRNGKey(0))
    m = tr.transformer_lm(VOCAB, EMBED, HEADS, LAYERS, max_len=MAX_LEN)
    p, s = to_jax_params(m)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), p) == shapes
    assert set(p["2"]["0"]["0"]["0"]["1"]) == {"wq", "wk", "wv", "wo", "bq",
                                               "bk", "bv", "bo"}
    assert p["1"]["weight"].shape == (MAX_LEN, EMBED)
    load_jax_params(m, jax.tree_util.tree_map(np.asarray, jp)).eval()
    x = tokens((2, 9), 5)
    jy, _ = jm.apply(jp, js, jnp.asarray(x))
    with torch.no_grad():
        assert err(m(torch.from_numpy(x)).numpy(), jy) <= TOL


def test_forward_matches_reference(pair):
    m, jm, jp = pair
    x = tokens((3, 12), 1)
    jy, _ = jm.apply(jp, jtree(to_jax_params(m)[1]), jnp.asarray(x))
    with torch.no_grad():
        assert err(m(torch.from_numpy(x)).numpy(), jy) <= TOL


def test_prefill_matches_reference_and_full_context(pair):
    m, jm, jp = pair
    x = tokens((2, 10), 2)
    with torch.no_grad():
        lp, k, v = tr.transformer_lm_prefill(m, torch.from_numpy(x))
        full = m(torch.from_numpy(x)).numpy()
    jl, jk, jv = jtr.transformer_lm_prefill(jm, jp, jnp.asarray(x))
    assert k.shape == (LAYERS, 2, HEADS, 10, EMBED // HEADS)
    assert err(lp.numpy(), jl) <= TOL
    assert err(k.numpy(), jk) <= TOL and err(v.numpy(), jv) <= TOL
    assert err(lp.numpy(), full) <= TOL


def _decode_run(m, jm, jp, slots, tmax, schedule):
    """Drive both packages' decode steps through ``schedule``: a list of
    (tokens, lengths) pairs.  Returns the largest log-prob and cache
    differences."""
    k, v = tr.init_kv_cache(m, slots, tmax)
    jk, jv = jtr.init_kv_cache(jm, slots, tmax)
    worst = 0.0
    for toks, lens in schedule:
        with torch.no_grad():
            lp, k, v = tr.transformer_lm_decode_step(
                m, torch.from_numpy(toks), torch.from_numpy(lens), k, v)
        jl, jk, jv = jtr.transformer_lm_decode_step(
            jm, jp, jnp.asarray(toks), jnp.asarray(lens), jk, jv)
        assert torch.isfinite(lp).all()
        worst = max(worst, err(lp.numpy(), jl), err(k.numpy(), jk),
                    err(v.numpy(), jv))
    return worst


def test_every_decode_step_matches_reference(pair):
    m, jm, jp = pair
    rng = np.random.default_rng(6)
    schedule = [(rng.integers(0, VOCAB, 3).astype(np.int32),
                 np.array([t, max(0, t - 4), t // 2], np.int32))
                for t in range(14)]
    assert _decode_run(m, jm, jp, 3, 16, schedule) <= TOL


def test_slot_at_max_seq_len_clamps_like_the_reference(pair):
    """An idle slot's stale write head at ``max_seq_len`` (and past it):
    the reference's ``dynamic_update_slice`` clamps the write to the last
    position and its gather clamps the positional row; the port clamps
    both explicitly, so the step neither faults nor differs, and the slot
    then decodes from 0 again."""
    m, jm, jp = pair
    tmax = 8
    up = [(np.array([5, 9], np.int32), np.array([t, t], np.int32))
          for t in range(tmax)]
    at_max = [(np.array([3, 4], np.int32), np.array([tmax, tmax + 3],
                                                    np.int32))] * 2
    back = [(np.array([7, 1], np.int32), np.array([t, tmax], np.int32))
            for t in range(4)]
    assert _decode_run(m, jm, jp, 2, tmax, up + at_max + back) <= TOL
    pos = MAX_LEN + 5  # past the positional table
    assert _decode_run(m, jm, jp, 1, MAX_LEN, [
        (np.array([2], np.int32), np.array([pos], np.int32))]) <= TOL


def test_incremental_decode_equals_full_context_every_step(pair):
    """The port's own gate: feeding a sequence one token at a time
    through the cache gives the full-context forward's last-position
    log-probs at every step."""
    m, _, _ = pair
    seq = tokens((1, 20), 8)[0]
    k, v = tr.init_kv_cache(m, 1, 24)
    with torch.no_grad():
        lp0, kp, vp = tr.transformer_lm_prefill(
            m, torch.from_numpy(seq[None, :4]))
        k[:, :, :, :4] = kp
        v[:, :, :, :4] = vp
        for t in range(4, 20):
            lp, k, v = tr.transformer_lm_decode_step(
                m, torch.from_numpy(seq[t:t + 1]),
                torch.tensor([t]), k, v)
            full = m(torch.from_numpy(seq[None, :t + 1]))[0, -1]
            assert err(lp[0].numpy(), full.numpy()) <= TOL, t


def _planted(pair, fault):
    """The largest log-prob difference from the reference's decode steps
    with one fault planted in the port's path."""
    m, jm, jp = pair
    schedule = [(np.array([t % VOCAB, 3], np.int32),
                 np.array([t, t], np.int32)) for t in range(8)]
    orig_write, orig_softmax = tr.write_kv, tr.masked_softmax
    mha = m[2][0][0][0][1]
    try:
        if fault == "wq_transposed":
            with torch.no_grad():
                mha.wq.copy_(mha.wq.T.clone())
        elif fault == "position_off_by_one":
            tr.write_kv = lambda c, n, s: orig_write(c, n, s + 1)
        elif fault == "causal_strict":
            # ki < p in place of ki <= p: each row loses its last key
            tr.masked_softmax = lambda s, keep: orig_softmax(
                s, keep & torch.roll(keep, -1, -1))
        return _decode_run(m, jm, jp, 2, 16, schedule)
    finally:
        tr.write_kv, tr.masked_softmax = orig_write, orig_softmax
        if fault == "wq_transposed":
            with torch.no_grad():
                mha.wq.copy_(mha.wq.T.clone())


@pytest.mark.parametrize("fault", ["wq_transposed", "position_off_by_one",
                                   "causal_strict"])
def test_planted_faults_read_above_the_limit(pair, fault):
    reading = _planted(pair, fault)
    assert reading > FAULT_FLOOR > TOL, reading
    assert _planted(pair, None) <= TOL
