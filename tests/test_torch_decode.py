"""``bigdl_tpu_torch.serving.DecodeService`` against the reference's
``TestDecodeService`` contract (``tests/test_decode_serving.py``), on the
CPU with a 2-layer, embed-32, vocab-64 ``transformer_lm``.

Greedy tokens are checked two ways: equal to the port's own full-context
greedy run token for token (the reference's gate, inside one package),
and equal to the reference's tokens from the same numpy weights wherever
the reference's top-2 log-prob margin exceeds ``2 * LOGP_TOL`` (every
position here: across packages a near-tie could flip), with every
generated token's log-prob within ``LOGP_TOL = 1e-5`` of the reference's
full-context forward over the same tokens (teacher forcing: sound
readings ~1e-6).
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models.transformer import (kv_cache_spec,  # noqa: E402
                                                transformer_lm)
from bigdl_tpu_torch.serving import (DeadlineExceeded,  # noqa: E402
                                     DecodeService, ModelRegistry,
                                     RequestSpecError, ServiceClosed,
                                     ServiceOverloaded)

VOCAB = 64
LOGP_TOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    return transformer_lm(vocab_size=VOCAB, embed_dim=32, num_heads=4,
                          num_layers=2, max_len=64).initialize(0).eval()


@pytest.fixture(scope="module")
def ref(lm):
    """The reference model and its forward over the port's weights."""
    params, state = to_jax_params(lm)
    jm = jax_lm(vocab_size=VOCAB, embed_dim=32, num_heads=4, num_layers=2,
                max_len=64)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, state)
    fwd = jax.jit(lambda x: jm.apply(p, s, x, training=False)[0])
    return lambda toks: np.asarray(fwd(jnp.asarray([toks], jnp.int32)))[0]


def greedy_ref(model, prompt, max_new, eos_id=None, max_seq_len=64):
    """The port's per-request full-context greedy run: the whole grown
    sequence through the model for every next token."""
    toks = [int(t) for t in prompt]
    max_new = min(int(max_new), max_seq_len - len(toks))
    out = []
    for _ in range(max_new):
        with torch.no_grad():
            lp = model(torch.tensor([toks]))
        nxt = int(lp[0, -1].argmax())
        out.append(nxt)
        if eos_id is not None and nxt == eos_id:
            break
        toks.append(nxt)
        if len(toks) >= max_seq_len:
            break
    return out


def check_against_reference(ref, prompt, tokens):
    """Teacher-forced: the reference's full-context forward over prompt
    + the port's tokens.  Each token's log-prob within LOGP_TOL of the
    reference's, and equal to the reference's argmax wherever its top-2
    margin exceeds twice that."""
    seq = list(prompt) + [int(t) for t in tokens]
    lp = ref(seq)
    n0 = len(prompt)
    for i, tok in enumerate(tokens):
        row = lp[n0 - 1 + i]
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > 2 * LOGP_TOL:
            assert tok == int(row.argmax()), i
        assert row[tok] >= row.max() - 2 * LOGP_TOL, i


def wait_until(pred, timeout=10.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def svc(lm, **kw):
    kw.setdefault("device", "cpu")
    return DecodeService(lm, **kw)


def test_single_request_equals_reference(lm, ref):
    with svc(lm, slots=2, max_seq_len=48, max_prompt_len=8,
             prefill_buckets="top", name="d1") as dec:
        prompt = [5, 9, 3]
        res = dec.generate(prompt, max_new_tokens=6)
    assert list(res.tokens) == greedy_ref(lm, prompt, 6, max_seq_len=48)
    check_against_reference(ref, prompt, res.tokens)
    assert res.finish_reason == "length"
    assert res.prompt_len == 3 and res.prefill_bucket >= 3
    assert res.admit_step <= res.finish_step


def test_concurrent_mixed_lengths_equal_reference(lm, ref):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, (n,)).tolist()
               for n in (2, 5, 9, 14, 3, 7)]
    with svc(lm, slots=3, max_seq_len=48, max_prompt_len=16,
             prefill_buckets="top", name="dmix") as dec:
        futs = [dec.submit(p, max_new_tokens=4 + i % 3)
                for i, p in enumerate(prompts)]
        results = [f.result(timeout=120) for f in futs]
    for i, (p, res) in enumerate(zip(prompts, results)):
        assert list(res.tokens) == greedy_ref(lm, p, 4 + i % 3,
                                              max_seq_len=48), i
        check_against_reference(ref, p, res.tokens)
    assert {r.slot for r in results} <= set(range(3))


def test_mid_batch_admission_by_step_accounting(lm):
    fut_b = []
    dec = svc(lm, slots=2, max_seq_len=48, max_prompt_len=8,
              prefill_buckets="top", name="dmid")

    def on_token(index, token):
        if index == 2 and not fut_b:
            fut_b.append(dec.submit([11, 2], max_new_tokens=3))

    try:
        res_a = dec.submit([5, 9, 3, 1], max_new_tokens=12,
                           on_token=on_token).result(timeout=120)
        assert fut_b, "on_token never fired at index 2"
        res_b = fut_b[0].result(timeout=120)
    finally:
        dec.stop()
    assert list(res_a.tokens) == greedy_ref(lm, [5, 9, 3, 1], 12,
                                            max_seq_len=48)
    assert list(res_b.tokens) == greedy_ref(lm, [11, 2], 3, max_seq_len=48)
    assert res_a.admit_step <= res_b.admit_step < res_a.finish_step
    assert res_a.slot != res_b.slot


def test_on_token_streams_every_token_in_order(lm):
    seen = []
    with svc(lm, slots=1, max_seq_len=48, max_prompt_len=8,
             prefill_buckets="top", name="dstr") as dec:
        res = dec.generate([5, 9, 3], max_new_tokens=5,
                           on_token=lambda i, t: seen.append((i, t)))
    assert [i for i, _ in seen] == list(range(len(res.tokens)))
    assert [t for _, t in seen] == list(res.tokens)


def test_slot_reuse_after_eos(lm):
    ref = greedy_ref(lm, [5, 9, 3], 10, max_seq_len=48)
    eos = next(t for i, t in enumerate(ref) if ref.index(t) == i and i >= 1)
    k = ref.index(eos)
    ref_eos = greedy_ref(lm, [5, 9, 3], 10, eos_id=eos, max_seq_len=48)
    assert ref_eos == ref[:k + 1] and len(ref_eos) >= 2
    with svc(lm, slots=1, max_seq_len=48, eos_id=eos, max_prompt_len=8,
             prefill_buckets="top", name="deos") as dec:
        fut_a = dec.submit([5, 9, 3], max_new_tokens=10)
        fut_b = dec.submit([7, 1, 4, 2], max_new_tokens=4)
        res_a = fut_a.result(timeout=120)
        res_b = fut_b.result(timeout=120)
    assert res_a.finish_reason == "eos"
    assert list(res_a.tokens) == ref_eos
    assert res_b.slot == res_a.slot
    assert res_b.admit_step >= res_a.finish_step
    assert list(res_b.tokens) == greedy_ref(lm, [7, 1, 4, 2], 4,
                                            eos_id=eos, max_seq_len=48)
    st = dec.stats()["decode"]
    assert st["slots_reclaimed"] >= 2 and st["admissions"] == 2


def test_slot_driven_to_max_seq_len_and_reused(lm, ref):
    """A sequence runs its slot to ``max_seq_len`` (finish "length"), and
    while it does, the idle slot's stale write head sits at 0 and the
    finished slot's at ``max_seq_len`` — the clamped writes the step
    makes for them must not disturb the next occupant."""
    with svc(lm, slots=2, max_seq_len=16, max_prompt_len=8,
             prefill_buckets="top", name="dmax") as dec:
        res = dec.generate([1, 2, 3], max_new_tokens=100)
        assert res.finish_reason == "length" and len(res.tokens) == 13
        assert list(res.tokens) == greedy_ref(lm, [1, 2, 3], 100,
                                              max_seq_len=16)
        # the slot that held it is reused, and a concurrent long one
        # drives the other slot to the cap while the first decodes
        futs = [dec.submit([4, 5], max_new_tokens=3),
                dec.submit([6, 7, 8, 9, 10, 11, 12, 13], max_new_tokens=50)]
        short, long_ = [f.result(timeout=120) for f in futs]
        assert dec._lengths.max() <= 16
    assert list(short.tokens) == greedy_ref(lm, [4, 5], 3, max_seq_len=16)
    assert list(long_.tokens) == greedy_ref(
        lm, [6, 7, 8, 9, 10, 11, 12, 13], 50, max_seq_len=16)
    check_against_reference(ref, [1, 2, 3], res.tokens)


def test_request_spec_taxonomy(lm):
    with svc(lm, slots=1, max_seq_len=32, max_prompt_len=8,
             prefill_buckets="top", name="dspec") as dec:
        for bad, kw in [([[1, 2], [3, 4]], {}), ([], {}), ([1.5, 2.5], {}),
                        (list(range(40)), {}), ([1, 2],
                                                {"max_new_tokens": 0})]:
            with pytest.raises(RequestSpecError):
                dec.submit(bad, **kw)


def test_expired_deadline_settles_deadline_exceeded(lm):
    with svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
             prefill_buckets="top", name="ddl") as dec:
        fut = dec.submit([1, 2, 3], deadline=time.monotonic() - 0.001)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=60)


def test_overload_sheds_with_service_overloaded(lm):
    dec = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", queue_capacity=2, name="dover",
              start=False)
    try:
        dec.submit([1, 2])
        dec.submit([3, 4])
        with pytest.raises(ServiceOverloaded):
            dec.submit([5, 6])
    finally:
        dec.stop(drain=False)


def test_stop_then_submit_service_closed(lm):
    dec = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", name="dcl")
    dec.stop()
    with pytest.raises(ServiceClosed):
        dec.submit([1, 2])


def test_nondrain_stop_cancels_backlog_and_active(lm):
    dec = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", name="dnd")
    entered, release = threading.Event(), threading.Event()

    def park(index, token):
        entered.set()
        release.wait(30)

    try:
        fut_a = dec.submit([1, 2], max_new_tokens=8, on_token=park)
        assert entered.wait(30)
        fut_b = dec.submit([3, 4])
        dec.stop(drain=False, timeout=0.01)
        release.set()
        with pytest.raises(ServiceClosed):
            fut_a.result(timeout=60)
        with pytest.raises(ServiceClosed):
            fut_b.result(timeout=60)
    finally:
        release.set()
        dec.stop(drain=False)


def test_compile_count_frozen_after_construction(lm):
    with svc(lm, slots=2, max_seq_len=48, max_prompt_len=16,
             prefill_buckets="pow2@4", name="dtrace") as dec:
        warm = dec.compile_count
        assert warm == 1 + 2 * len(dec.buckets) == 7
        for n in (1, 3, 4, 7, 12):
            dec.generate(list(range(1, n + 1)), max_new_tokens=3)
        assert dec.compile_count == warm
        assert dec.stats()["compile_count"] == warm


def test_kv_budget_is_a_hard_cap(lm):
    shape, dtype = kv_cache_spec(lm, 1, 32)
    per_slot_mb = 2 * int(np.prod(shape)) * dtype.itemsize / (1 << 20)
    dec = svc(lm, slots=8, max_seq_len=32, max_prompt_len=4,
              prefill_buckets="top", kv_budget_mb=per_slot_mb * 2.5,
              name="dkv", start=False)
    assert dec.slots == 2
    assert dec.kv_bytes <= per_slot_mb * 2.5 * (1 << 20)
    assert dec._k.shape == (2, 2, 4, 32, 8) == dec._v.shape
    dec.stop(drain=False)
    with pytest.raises(ValueError):
        svc(lm, slots=1, max_seq_len=32, max_prompt_len=4,
            prefill_buckets="top", kv_budget_mb=per_slot_mb * 0.4,
            start=False)


def test_stats_schema(lm):
    with svc(lm, slots=2, max_seq_len=32, max_prompt_len=4,
             prefill_buckets="top", name="dst") as dec:
        dec.generate([1, 2, 3], max_new_tokens=4)
        st = dec.stats()
    d = st["decode"]
    assert d["slots"] == 2 and d["active"] == 0
    assert d["steps"] >= 3 and d["tokens_generated"] >= 4
    assert d["admissions"] == 1 and d["slots_reclaimed"] == 1
    assert 0.0 < d["step_occupancy"] <= 1.0
    assert d["kv_bytes"] > 0 and d["prefill_buckets"]
    assert st["requests_completed"] == 1


def test_scheduler_crash_settles_inflight_futures(lm):
    dec = svc(lm, slots=2, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", name="crash")

    def boom(*a, **kw):
        raise RuntimeError("injected step failure")

    try:
        dec._step_exec = boom
        fut = dec.submit([5, 9, 3], max_new_tokens=4)
        with pytest.raises(RuntimeError, match="injected step"):
            fut.result(timeout=30)
        wait_until(lambda: not dec.alive)
        with pytest.raises(ServiceClosed):
            dec.submit([1, 2])
    finally:
        dec.stop(drain=False, timeout=5)


def test_scheduler_crash_in_prefill_settles_the_sequence_in_hand(lm):
    """A crash while a popped sequence is being admitted (its prefill)
    settles that sequence's future and every queued one: none of them
    is in the queue or a slot when the scheduler dies."""
    dec = svc(lm, slots=2, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", name="crash-prefill", start=False)

    def boom(tokens):
        raise RuntimeError("injected prefill failure")

    try:
        dec._prefill = boom
        futs = [dec.submit([1, 2]), dec.submit([3]), dec.submit([4, 5])]
        dec.start()
        for f in futs:
            with pytest.raises(RuntimeError, match="injected prefill"):
                f.result(timeout=30)
        wait_until(lambda: not dec.alive)
    finally:
        dec.stop(drain=False, timeout=5)


def test_out_of_vocabulary_prompt_refused(lm):
    with svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
             prefill_buckets="top", name="oov") as dec:
        for bad in ([1, VOCAB], [-1, 2]):
            with pytest.raises(RequestSpecError, match="token ids"):
                dec.submit(bad)
        assert len(dec.generate([VOCAB - 1, 0], max_new_tokens=2).tokens) \
            == 2


def test_priority_fn_admits_best_rank_under_pressure(lm):
    order = []
    dec = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", name="dprio", start=False,
              priority_fn=lambda req: 0 if req.ctx == "hi" else 5)
    try:
        for tag in ("lo", "lo", "hi"):
            dec.submit([1, 2], max_new_tokens=1, ctx=tag,
                       on_token=lambda i, t, g=tag: order.append(g))
        dec.start()
        wait_until(lambda: len(order) == 3, 60, "three admissions")
    finally:
        dec.stop()
    assert order[0] == "hi"


def test_device_mesh_and_params(lm):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DecodeService(lm, slots=1, max_seq_len=16, start=False)
    # a sharded decode backend needs a mesh with a model device group
    with pytest.raises(ValueError, match="model device group"):
        svc(lm, slots=1, max_seq_len=16, mesh=object(), start=False)
    # params= in the reference's layout load into a copy: the caller's
    # module keeps its weights
    params, _ = to_jax_params(lm)
    zeroed = {**params, "1": {"weight": np.zeros_like(params["1"]["weight"])}}
    dec = svc(lm, params=zeroed, slots=1, max_seq_len=16, start=False)
    assert dec._model is not lm
    assert float(dec._model[1].weight.abs().max()) == 0.0
    assert float(lm[1].weight.abs().max()) > 0.0
    dec.stop(drain=False)


def test_deploy_service_contract(lm):
    reg = ModelRegistry(device="cpu")
    dec = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
              prefill_buckets="top", start=False)
    try:
        with pytest.raises(ValueError):
            reg.deploy("x", lm, service=dec)
        with pytest.raises(ValueError):
            reg.deploy("x", service=dec, max_batch_size=4)
        reg.deploy("x", service=dec)
        assert reg.get("x", reg.latest_version("x")) is dec
        assert reg.latest_version("nope") is None
    finally:
        reg.stop_all()
    dec2 = svc(lm, slots=1, max_seq_len=16, max_prompt_len=4,
               prefill_buckets="top")
    reg.deploy("y", service=dec2)
    reg.undeploy("y", drain=True)
    assert not dec2.alive
    with pytest.raises(ServiceClosed):
        dec2.submit([1, 2])
