"""``bigdl_tpu_torch.serving.ShardedReplicaSet`` and
``DecodeService(mesh=)`` against the reference's ``TestShardedReplicaSet``
(``tests/test_decode_serving.py``), on the CPU: every case of that class
has a twin here, the device groups being lists of ``"cpu"`` (so the
groups' device identities coincide, and the placement case checks each
slot's group index and its shards' shapes instead of disjoint devices).

Limits: a sharded predict within ``rtol=1e-5, atol=1e-6`` of the
reference's unsharded forward on the same weights (the reference's
limits); the front end's rows within ``rtol=1e-6, atol=1e-7`` of the set's
own predict; sharded decode at ``model=4`` on the reference's small LM:
greedy tokens equal to the reference's full-context greedy run, each
token's log-prob within ``LOGP_TOL = 1e-5`` of the reference's
full-context forward (teacher forcing), and at ``model=8`` over 4 heads
(the axis does not divide them) the cache whole on the home device and
the same tokens.
"""

import http.client
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.frontend import FrontendServer  # noqa: E402
from bigdl_tpu_torch.interop import to_jax_params  # noqa: E402
from bigdl_tpu_torch.models.transformer import (ShardedKV,  # noqa: E402
                                                transformer_lm,
                                                transformer_lm_decode_step,
                                                transformer_lm_prefill)
from bigdl_tpu_torch.parallel import Shards, Spec, create_mesh  # noqa: E402
from bigdl_tpu_torch.resilience import ReplicaSet  # noqa: E402
from bigdl_tpu_torch.serving import (DecodeService, ModelRegistry,  # noqa: E402
                                     ShardedReplicaSet)

CPU8 = ["cpu"] * 8
SPEC16 = ((16,), np.float32)
VOCAB = 64
LOGP_TOL = 1e-5


def make_mlp(module=nn, din=16, dout=4, shard=False):
    m = module.Sequential(
        module.Linear(din, 32, shard="column" if shard else None),
        module.ReLU(),
        module.Linear(32, dout, shard="row" if shard else None),
        module.SoftMax())
    return m.initialize(0) if module is nn else m


def ref_forward(model, x):
    """The reference's unsharded forward over ``model``'s weights."""
    jm = make_mlp(jnn)
    params, state = to_jax_params(model)
    y, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params),
                    jax.tree_util.tree_map(jnp.asarray, state), x,
                    training=False)
    return np.asarray(y)


class TestShardedReplicaSet:
    def test_validation(self):
        model = make_mlp()
        with pytest.raises(ValueError):
            ShardedReplicaSet(model, devices_per_replica=0, devices=CPU8)
        with pytest.raises(ValueError):
            ShardedReplicaSet(model, devices_per_replica=16,
                              devices=CPU8)  # > 8 devs
        with pytest.raises(ValueError):
            ShardedReplicaSet(model, devices_per_replica=4,
                              mesh_axes={"bogus": 4}, devices=CPU8)
        with pytest.raises(ValueError):
            ShardedReplicaSet(model, devices_per_replica=4,
                              mesh_axes={"model": 2},
                              devices=CPU8)  # 2 != 4
        if not torch.cuda.is_available():  # default: every CUDA device
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ShardedReplicaSet(model, devices_per_replica=2)

    def test_params_land_with_declared_shardings(self):
        """Each slot's copy carries the layers' declared splits over its
        own group: the column weight in four (8, 16) slices, the row
        weight in four (4, 8) slices, everything else whole on the home
        device; slot ix takes group ix % groups."""
        model = make_mlp(shard=True)
        rs = ShardedReplicaSet(model, devices_per_replica=4,
                               input_spec=SPEC16, start=False,
                               devices=CPU8)
        try:
            assert rs.n_replicas == 2  # 8 devices / 4 per slice
            for ix in range(2):
                svc = rs._replicas[ix]
                mesh = rs.replica_mesh(ix)
                assert mesh.shape["model"] == 4 and svc._mesh is mesh
                assert rs.group_index(ix) == ix
                assert list(mesh.devices) == rs._groups[ix]
                w0 = svc.model[0].weight  # column Linear
                assert isinstance(w0, Shards) and w0.spec == \
                    Spec("model", None)
                assert [tuple(p.shape) for p in w0.parts] == [(8, 16)] * 4
                w2 = svc.model[2].weight  # row Linear
                assert w2.spec == Spec(None, "model")
                assert [tuple(p.shape) for p in w2.parts] == [(4, 8)] * 4
                assert w0.devices == mesh.devices
                assert isinstance(svc.model[2].bias, torch.nn.Parameter)
                assert svc.model is not model  # the set's own copy
            assert rs.group_index(2) == 0  # round-robin past the groups
        finally:
            rs.stop()

    def test_sharded_predict_equals_single_device(self):
        model = make_mlp(shard=True)
        rs = ShardedReplicaSet(model, devices_per_replica=4,
                               input_spec=SPEC16, devices=CPU8)
        try:
            x = np.random.default_rng(0).normal(
                0, 1, (6, 16)).astype(np.float32)
            got = np.asarray(rs.predict(x))
            np.testing.assert_allclose(got, ref_forward(model, x),
                                       rtol=1e-5, atol=1e-6)
        finally:
            rs.stop()

    @pytest.mark.parametrize("core", ["eventloop", "threaded"])
    def test_serves_through_unchanged_frontend(self, core):
        """Zero front-end changes: the front end's ReplicaSet dispatch
        sees the subclass and the wire path serves it, on both cores."""
        model = make_mlp(shard=True)
        rs = ShardedReplicaSet(model, devices_per_replica=2,
                               n_replicas=2, input_spec=SPEC16,
                               devices=CPU8)
        assert isinstance(rs, ReplicaSet)
        reg = ModelRegistry(device="cpu")
        fe = FrontendServer(reg, port=0, core=core)
        fe.add_backend("shmlp", rs)
        fe.start()
        try:
            x = np.random.default_rng(1).normal(
                0, 1, (3, 16)).astype(np.float32)
            conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                              timeout=60)
            conn.request("POST", "/v1/models/shmlp/predict",
                         body=json.dumps({"inputs": x.tolist()}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            assert resp.status == 200, body
            got = np.asarray(json.loads(body)["outputs"], np.float32)
            ref = np.asarray(rs.predict(x))
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        finally:
            fe.stop()
            rs.stop()

    def test_elastic_resize_keeps_mesh_granularity(self):
        model = make_mlp(shard=True)
        rs = ShardedReplicaSet(model, devices_per_replica=2,
                               n_replicas=1, input_spec=SPEC16,
                               devices=CPU8)
        try:
            rs.set_replica_count(3)  # 3 <= 8 // 2 groups
            assert rs.n_replicas == 3
            for ix in range(3):
                assert rs.replica_mesh(ix).shape["model"] == 2
                assert len(rs._replicas[ix].model[0].weight) == 2
            x = np.random.default_rng(2).normal(
                0, 1, (4, 16)).astype(np.float32)
            got = np.asarray(rs.predict(x))
            assert got.shape == (4, 4)
            np.testing.assert_allclose(got, ref_forward(model, x),
                                       rtol=1e-5, atol=1e-6)
            st = rs.stats()
            assert len(st["replicas"]) == 3
        finally:
            rs.stop()


# ---------------------------------------------------------- sharded decode
@pytest.fixture(scope="module")
def sharded_lm():
    return transformer_lm(vocab_size=VOCAB, embed_dim=32, num_heads=4,
                          num_layers=2, max_len=64, shard=True).initialize(0)


@pytest.fixture(scope="module")
def ref(sharded_lm):
    """The reference's full-context forward over the port's weights."""
    params, state = to_jax_params(sharded_lm)
    jm = jax_lm(vocab_size=VOCAB, embed_dim=32, num_heads=4, num_layers=2,
                max_len=64)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    s = jax.tree_util.tree_map(jnp.asarray, state)
    fwd = jax.jit(lambda x: jm.apply(p, s, x, training=False)[0])
    return lambda toks: np.asarray(fwd(jnp.asarray([toks], jnp.int32)))[0]


def ref_greedy(ref, prompt, max_new):
    toks, out = list(prompt), []
    for _ in range(max_new):
        nxt = int(ref(toks)[-1].argmax())
        out.append(nxt)
        toks.append(nxt)
    return out


def teacher_forced(model, prompt, tokens):
    """The log-probs the service's decode carry gives each token: a
    prefill of the prompt, then one decode step a token, over the
    model's own (placed) caches."""
    with torch.no_grad():
        lp, k, v = transformer_lm_prefill(model, torch.tensor([prompt]))
        rows = [lp[0, -1]]
        length = len(prompt)
        # grow a cache with room for the tokens: splice the prefill in
        from bigdl_tpu_torch.models.transformer import (init_kv_cache,
                                                        splice_kv)
        kc, vc = init_kv_cache(model, 1, length + len(tokens))
        splice_kv(kc, k, 0)
        splice_kv(vc, v, 0)
        for tok in tokens[:-1]:
            lp, kc, vc = transformer_lm_decode_step(
                model, torch.tensor([tok]), torch.tensor([length]), kc, vc)
            rows.append(lp[0])
            length += 1
    return torch.stack(rows).numpy()


@pytest.mark.parametrize("m,split", [(4, True), (8, False)])
def test_sharded_decode_service_equals_reference(sharded_lm, ref, m, split):
    """The reference's ``test_sharded_decode_service_equals_reference``:
    ``DecodeService(mesh=)`` at ``model=4`` gives the reference's greedy
    tokens, with the KV cache split on the heads (a quarter a device);
    teacher-forced, each token's log-prob is the reference's within
    ``LOGP_TOL``.  At ``model=8`` over 4 heads the cache is whole on the
    home device, and the tokens are the same."""
    prompt, n = [5, 9, 3], 4
    mesh = create_mesh(model=m, devices=["cpu"] * m)
    with DecodeService(sharded_lm, slots=2, max_seq_len=16, mesh=mesh,
                       max_prompt_len=4, prefill_buckets="top",
                       name="dsh") as dec:
        res = dec.generate(prompt, max_new_tokens=n)
        assert isinstance(dec._k, ShardedKV) is split
        assert dec.kv_bytes_per_shard * (m if split else 1) == dec.kv_bytes
        assert dec.stats()["decode"]["kv_bytes_per_shard"] == \
            dec.kv_bytes_per_shard
        placed = dec._model
    assert dec.device == torch.device("cpu")
    assert isinstance(placed[2][0][0][0][1].wq, Shards)
    assert not isinstance(sharded_lm[2][0][0][0][1].wq, Shards)  # a copy
    assert list(res.tokens) == ref_greedy(ref, prompt, n)
    want = ref(prompt + list(res.tokens))
    got = teacher_forced(placed, prompt, list(res.tokens))
    rows = want[len(prompt) - 1:len(prompt) - 1 + n]
    assert np.abs(got - rows).max() <= LOGP_TOL


def test_decode_mesh_needs_a_model_group(sharded_lm):
    with pytest.raises(ValueError, match="model device group"):
        DecodeService(sharded_lm, slots=1, max_seq_len=16,
                      mesh=create_mesh(data=1), start=False)
    mesh = create_mesh(model=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="home device"):
        DecodeService(sharded_lm, slots=1, max_seq_len=16, mesh=mesh,
                      device="meta", start=False)
