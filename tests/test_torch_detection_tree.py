"""The detection heads and the tree LSTM of the port on the CPU, against
the reference (``nn/detection.py``, ``nn/tree.py``).

- The reference's own contract (``tests/test_detection_tree.py``): anchors,
  NMS (overlaps suppressed, a static output, identical boxes kept once),
  ``PriorBox``'s Caffe layout, ``Proposal``'s shapes, ``RoiPooling`` on a
  hand-checked map and with batch indices and a scale, the SSD and Faster
  R-CNN heads (decode, per-class NMS, the global cut), ``BinaryTreeLSTM``'s
  shapes, padding rows, gradients and a deep chain.
- The same functions against the reference on seeded inputs with planted
  ties (scores rounded to 0.1 or 0.01): NMS indices and valid masks
  equal, first index on ties, every slot after the last live box unused,
  an all-suppressed row all unused, with boxes shared by the rows or each
  row's own; the heads' valid masks equal and their detections within
  5e-6 (box decoding in f32, another order of the same operations);
  ``PriorBox`` and
  ``RoiPooling`` equal, the latter also over chunks of RoIs.
- ``BinaryTreeLSTM`` against the reference through carried weights,
  forward and the gradients of ``sum(out * cot)``, on random binary trees
  with padding rows, a child that points at its own row and one past the
  last: within ``rtol=1e-5, atol=1e-5`` (readings ~3e-7 of max|.|); two
  planted faults (the composer's left and right weights swapped, the
  children read before the level schedule) read above 1e-2.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")  # the reference; absent on the card

import jax.numpy as jnp  # noqa: E402

from bigdl_tpu import nn as jnn  # noqa: E402
from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.interop import load_jax_params  # noqa: E402
from bigdl_tpu_torch.interop.jax_weights import jax_tree  # noqa: E402
from bigdl_tpu_torch.nn import detection as D  # noqa: E402
from bigdl_tpu_torch.nn import tree as T  # noqa: E402

TREE_TOL = dict(rtol=1e-5, atol=1e-5)
DET_ATOL = 5e-6
FAULT_FLOOR = 1e-2


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# the reference's NMS and heads, jitted: one compile per shape
_jnms = jax.jit(jnn.nms, static_argnums=(2, 3))


def _japply(module, *args):
    """The reference module's output on host arrays, jitted."""
    return jax.jit(lambda a: module.apply({}, {}, a)[0])(
        tuple(map(jnp.asarray, args)) if len(args) > 1
        else jnp.asarray(args[0]))


# ----------------------------------------------- the reference's contract
def test_anchor_basic_and_grid():
    a = nn.Anchor(ratios=[1.0], scales=[8.0])
    b = a.basic_anchors[0]
    assert b[2] - b[0] + 1 == 128 and b[3] - b[1] + 1 == 128
    np.testing.assert_allclose((b[0] + b[2]) / 2, 7.5)
    a = nn.Anchor(ratios=[0.5, 1.0, 2.0], scales=[8.0, 16.0, 32.0])
    all_a = a.generate_anchors(width=4, height=3, feat_stride=16)
    assert all_a.shape == (4 * 3 * 9, 4)
    np.testing.assert_allclose((all_a[9] - all_a[0]).numpy(), [16, 0, 16, 0])
    ref = jnn.Anchor([0.5, 1.0, 2.0], [8.0, 16.0, 32.0])
    np.testing.assert_array_equal(
        all_a.numpy(), np.asarray(ref.generate_anchors(4, 3, 16)))


def test_nms_contract():
    boxes = t([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]])
    idx, valid = nn.nms(boxes, t([0.9, 0.8, 0.7]), 0.5, 3)
    assert idx[valid].tolist() == [0, 2]
    idx, valid = nn.nms(t([[0, 0, 5, 5]] * 8), torch.arange(8.0), 0.5, 4)
    assert idx.shape == (4,) and int(valid.sum()) == 1
    assert idx.tolist() == [7, -1, -1, -1]
    idx, valid = nn.Nms()(t([0.9, 0.8, 0.7]), boxes, 0.5, 3)
    assert idx.tolist() == [0, 2, -1]
    # the reference's indices are int32, from nms and Nms alike
    want = _jnms(jnp.asarray(boxes.numpy()), jnp.asarray([0.9, 0.8, 0.7]),
                 0.5, 3)[0]
    assert idx.dtype == torch.int32 and str(want.dtype) == "int32"
    assert nn.nms(boxes, t([0.9, 0.8, 0.7]), 0.5, 3)[0].dtype == torch.int32


def test_prior_box_caffe_layout():
    pb = nn.PriorBox(min_sizes=[30.0], max_sizes=[60.0],
                     aspect_ratios=[2.0], is_flip=True,
                     variances=[0.1, 0.1, 0.2, 0.2],
                     img_h=300, img_w=300, step=8.0)
    assert pb.n_priors == 4
    out = pb(torch.zeros(1, 8, 2, 2))
    assert out.shape == (1, 2, 2 * 2 * 4 * 4)
    pr = out[0, 0].reshape(2, 2, 4, 4).numpy()
    np.testing.assert_allclose(pr[0, 0, 0], [(4 - 15) / 300] * 2
                               + [(4 + 15) / 300] * 2, rtol=1e-5)
    var = out[0, 1].reshape(-1, 4).numpy()
    np.testing.assert_allclose(var, np.tile([0.1, 0.1, 0.2, 0.2],
                                            (var.shape[0], 1)))


def test_proposal_shapes_and_validity():
    A, H, W = 9, 6, 6
    rng = np.random.RandomState(0)
    scores = rng.rand(1, 2 * A, H, W).astype(np.float32)
    deltas = ((rng.rand(1, 4 * A, H, W) - 0.5) * 0.1).astype(np.float32)
    out, valid = nn.Proposal(50, 10, [0.5, 1.0, 2.0], [2.0, 4.0, 8.0])(
        (t(scores), t(deltas), t([[96.0, 96.0, 1.0, 1.0]])))
    assert out.shape == (10, 5) and bool(valid.any())
    v = out[valid].numpy()
    assert (v[:, 0] == 0).all()
    assert (v[:, 1] >= 0).all() and (v[:, 3] <= 95).all()


def test_roi_pooling_contract():
    data = torch.arange(16.0).reshape(1, 1, 4, 4)
    out = nn.RoiPooling(2, 2, 1.0)((data, t([[0, 0, 0, 3, 3]])))
    np.testing.assert_allclose(out[0, 0].numpy(), [[5, 7], [13, 15]])
    rng = np.random.RandomState(1)
    data = rng.rand(2, 3, 8, 8).astype(np.float32)
    out = nn.RoiPooling(4, 4, 0.5)((t(data), t([[0, 0, 0, 14, 14],
                                                [1, 0, 0, 14, 14]])))
    assert out.shape == (2, 3, 4, 4)
    np.testing.assert_allclose(
        out[1, 0].numpy(), data[1, 0].reshape(4, 2, 4, 2).max((1, 3)))


def test_detection_output_ssd_contract():
    P, C = 4, 3
    priors = np.zeros((1, 2, P * 4), np.float32)
    boxes = np.array([[0.1, 0.1, 0.3, 0.3], [0.11, 0.11, 0.31, 0.31],
                      [0.6, 0.6, 0.8, 0.8], [0.0, 0.0, 1.0, 1.0]],
                     np.float32)
    priors[0, 0] = boxes.reshape(-1)
    priors[0, 1] = np.tile([0.1, 0.1, 0.2, 0.2], P)
    conf = np.full((1, P, C), 0.01, np.float32)
    conf[0, 0, 1], conf[0, 1, 1], conf[0, 2, 2] = 0.9, 0.8, 0.7
    dets, valid = nn.DetectionOutputSSD(n_classes=C, keep_topk=5,
                                        conf_thresh=0.1)(
        (torch.zeros(1, P * 4), t(conf.reshape(1, -1)), t(priors)))
    v = dets[0][valid[0]].numpy()
    assert len(v) == 2
    np.testing.assert_allclose(v[0, :2], [1, 0.9], rtol=1e-5)
    np.testing.assert_allclose(v[1, :2], [2, 0.7], rtol=1e-5)
    np.testing.assert_allclose(v[0, 2:], boxes[0], atol=1e-5)
    assert (dets[0][~valid[0]] == 0).all()


def test_detection_output_frcnn_contract():
    C, R = 3, 3
    rois = t([[0, 10, 10, 30, 30], [0, 12, 12, 32, 32], [0, 60, 60, 80, 80]])
    deltas = np.zeros((R, 4 * C), np.float32)
    deltas[2, 8] = 5.0 / 21.0
    scores = np.full((R, C), 0.01, np.float32)
    scores[0, 1], scores[1, 1], scores[2, 2] = 0.9, 0.85, 0.7
    dets, valid = nn.DetectionOutputFrcnn(n_classes=C, max_per_image=6,
                                          thresh=0.05)(
        (t([[100.0, 100.0, 1.0, 1.0]]), rois, t(deltas), t(scores)))
    v = dets[valid].numpy()
    assert len(v) == 2
    np.testing.assert_allclose(v[0, :2], [1, 0.9], rtol=1e-5)
    np.testing.assert_allclose(v[1, :2], [2, 0.7], rtol=1e-5)
    np.testing.assert_allclose(v[1, 2], 65.0, atol=0.6)
    rng = np.random.RandomState(0)
    out, valid = nn.DetectionOutputFrcnn(n_classes=4, max_per_image=9)(
        (t([[50.0, 50, 1, 1]]), t(rng.rand(8, 5) * 40),
         t((rng.rand(8, 16) - 0.5) * 0.1), t(rng.rand(8, 4))))
    assert out.shape == (9, 6) and valid.shape == (9,)


def _simple_tree():
    tree = np.array([[[0, 0, 1], [0, 0, 2], [1, 2, 0]]], np.float32)
    emb = np.random.RandomState(0).rand(1, 2, 5).astype(np.float32)
    return t(emb), t(tree)


def test_binary_tree_lstm_contract():
    emb, tree = _simple_tree()
    m = nn.BinaryTreeLSTM(5, 7).initialize(0)
    out = m((emb, tree))
    assert out.shape == (1, 3, 7) and float(out.abs().sum()) > 0
    assert not torch.allclose(out[0, 2], out[0, 0])
    padded = torch.cat([tree, torch.zeros(1, 2, 3)], 1)
    o = m((emb, padded))
    assert (o[0, 3:] == 0).all()
    torch.testing.assert_close(o[0, :3], out[0], rtol=1e-6, atol=0)
    for p in m.parameters():
        p.requires_grad_(True)
    e = emb.clone().requires_grad_(True)
    (m((e, tree))[:, -1] ** 2).sum().backward()
    assert any(float(p.grad.abs().sum()) > 0 for p in m.parameters())
    assert float(e.grad.abs().sum()) > 0
    chain = t([[[0, 0, 1], [0, 0, 2], [0, 0, 3], [0, 0, 4],
                [3, 4, 0], [2, 5, 0], [1, 6, 0]]])
    out = nn.BinaryTreeLSTM(5, 6).initialize(0)(
        (t(np.random.RandomState(1).rand(1, 4, 5)), chain))
    assert out.shape == (1, 7, 6) and bool(torch.isfinite(out).all())


# ------------------------------------------------ against the reference
def _clustered_boxes(rng, n):
    base = rng.uniform(0, 100, (8, 2))
    xy = base[rng.integers(0, 8, n)] + rng.normal(0, 1.5, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(12, 25, (n, 2))],
                          1).astype(np.float32)


def _tied_scores(rng, shape, step=0.1, floor=0.2):
    s = (np.round(rng.uniform(0, 1, shape) / step) * step).astype(np.float32)
    s[s < floor] = -np.inf
    return s


@pytest.mark.parametrize("layout", ["shared", "per_row", "one_at_a_time"])
def test_nms_rows_match_reference_with_ties(layout):
    """Boxes shared by the rows (SSD's classes), a row's own (Faster
    R-CNN's per-class regression), and :func:`nn.nms` row by row."""
    rng = np.random.default_rng(1)
    boxes = _clustered_boxes(rng, 160)
    scores = _tied_scores(rng, (10, 160))
    scores[3] = -np.inf  # every box below the threshold
    rows = boxes if layout == "shared" else np.stack(
        [boxes + rng.normal(0, 0.5, boxes.shape).astype(np.float32)
         for _ in range(10)])
    if layout == "one_at_a_time":
        got = [nn.nms(t(rows[r]), t(scores[r]), 0.5, 12) for r in range(10)]
        idx = torch.stack([g[0] for g in got])
        valid = torch.stack([g[1] for g in got])
    else:
        idx, valid = D.nms_rows(t(rows), t(scores), 0.5, 12)
    for r in range(10):
        b = rows if layout == "shared" else rows[r]
        wi, wv = _jnms(jnp.asarray(b), jnp.asarray(scores[r]), 0.5, 12)
        np.testing.assert_array_equal(idx[r].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(valid[r].numpy(), np.asarray(wv))
        n = int(valid[r].sum())
        assert valid[r, :n].all() and (idx[r, n:] == -1).all()
    assert int(valid[3].sum()) == 0


def test_nms_planted_fault_last_index_on_ties():
    """A greedy loop that takes the LAST of tied maxima picks other boxes
    than the reference's at these inputs."""
    rng = np.random.default_rng(1)
    boxes, scores = _clustered_boxes(rng, 160), _tied_scores(rng, (4, 160))
    flipped = D.nms_rows(t(boxes[::-1].copy()), t(scores[:, ::-1].copy()),
                         0.5, 12)[0]
    picked = torch.where(flipped >= 0, 159 - flipped, -1)
    want = np.stack([np.asarray(_jnms(jnp.asarray(boxes),
                                      jnp.asarray(s), 0.5, 12)[0])
                     for s in scores])
    assert not np.array_equal(picked.numpy(), want)


def _ssd_inputs(rng, N, P, C):
    c = rng.uniform(0.1, 0.9, (P, 2))
    wh = rng.uniform(0.05, 0.3, (P, 2))
    priors = np.zeros((1, 2, P * 4), np.float32)
    priors[0, 0] = np.concatenate([c - wh / 2, c + wh / 2], 1).reshape(-1)
    priors[0, 1] = np.tile([0.1, 0.1, 0.2, 0.2], P)
    loc = (rng.normal(size=(N, P * 4)) * 0.5).astype(np.float32)
    conf = np.round(rng.uniform(0, 1, (N, P * C)), 2).astype(np.float32)
    return loc, conf, priors


@pytest.mark.parametrize("nms_topk", [24, 400])
def test_ssd_matches_reference(nms_topk):
    rng = np.random.default_rng(0)
    N, P, C = 2, 240, 5
    args = _ssd_inputs(rng, N, P, C)
    kw = dict(n_classes=C, nms_topk=nms_topk, keep_topk=30,
              conf_thresh=0.3)
    wd, wv = _japply(jnn.DetectionOutputSSD(**kw), *args)
    dets, valid = nn.DetectionOutputSSD(**kw)(tuple(map(t, args)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))
    np.testing.assert_allclose(dets.numpy(), np.asarray(wd), rtol=0,
                               atol=DET_ATOL)


def test_frcnn_and_proposal_match_reference():
    rng = np.random.default_rng(2)
    R, C = 40, 5
    rois = np.concatenate([np.zeros((R, 1)), rng.uniform(0, 60, (R, 2)),
                           rng.uniform(60, 100, (R, 2))], 1)
    args = (np.array([[100.0, 110.0, 1.0, 1.0]]), rois,
            rng.normal(size=(R, 4 * C)) * 0.1,
            np.round(rng.uniform(0, 1, (R, C)), 2))
    args = tuple(np.asarray(a, np.float32) for a in args)
    wd, wv = _japply(jnn.DetectionOutputFrcnn(n_classes=C,
                                              max_per_image=20), *args)
    dets, valid = nn.DetectionOutputFrcnn(n_classes=C, max_per_image=20)(
        tuple(map(t, args)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))
    np.testing.assert_allclose(dets.numpy(), np.asarray(wd), rtol=0,
                               atol=DET_ATOL)
    A, H, W = 9, 8, 8
    args = (np.round(rng.uniform(size=(1, 2 * A, H, W)), 2),
            (rng.uniform(size=(1, 4 * A, H, W)) - 0.5) * 0.2,
            np.array([[128.0, 128.0, 1.0, 1.0]]))
    args = tuple(np.asarray(a, np.float32) for a in args)
    kw = dict(pre_nms_topn=200, post_nms_topn=30, ratios=[0.5, 1, 2],
              scales=[8, 16, 32])
    wo, wv = _japply(jnn.Proposal(**kw), *args)
    out, valid = nn.Proposal(**kw)(tuple(map(t, args)))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))
    np.testing.assert_allclose(out.numpy(), np.asarray(wo), rtol=0,
                               atol=DET_ATOL * 10)


def test_roi_pooling_and_prior_box_match_reference():
    rng = np.random.default_rng(3)
    data = rng.normal(size=(2, 3, 12, 14)).astype(np.float32)
    rois = np.array([[0, 1, 2, 30, 20], [1, 0, 0, 50, 40],
                     [0, 20, 10, 22, 12], [1, 5, 5, 5, 5],
                     [0, 60, 60, 70, 70]], np.float32)  # the last off the map
    want = _japply(jnn.RoiPooling(3, 2, 0.25), data, rois)
    m = nn.RoiPooling(3, 2, 0.25)
    np.testing.assert_array_equal(m((t(data), t(rois))).numpy(),
                                  np.asarray(want))
    m.chunk_bytes = 1  # one RoI a chunk
    np.testing.assert_array_equal(m((t(data), t(rois))).numpy(),
                                  np.asarray(want))
    kw = dict(min_sizes=[30.0], max_sizes=[60.0], aspect_ratios=[2.0, 3.0],
              variances=[0.1, 0.1, 0.2, 0.2], img_size=300, step=8.0,
              is_clip=True)
    x = np.zeros((1, 4, 5, 6), np.float32)
    # op by op: under jit XLA folds the divisions by the image size into
    # products, an ulp off the reference's own eager priors
    want, _ = jnn.PriorBox(**kw).apply({}, {}, jnp.asarray(x))
    np.testing.assert_array_equal(nn.PriorBox(**kw)(t(x)).numpy(),
                                  np.asarray(want))


def random_trees(B, L, rng, pad=2):
    """B random binary trees over L leaves each, children first, then
    ``pad`` padding rows: (B, 2L - 1 + pad, 3)."""
    out = []
    for _ in range(B):
        rows = [[0, 0, i + 1] for i in range(L)]
        live = list(range(1, L + 1))
        while len(live) > 1:
            i = int(rng.integers(0, len(live) - 1))
            rows.append([live[i], live[i + 1], 0])
            live[i:i + 2] = [len(rows)]
        out.append(rows + [[0, 0, 0]] * pad)
    return np.array(out, np.float32)


@functools.lru_cache(maxsize=None)
def _tree_reference():
    """(trees, embeddings, cotangent, the reference's weights, its output
    and its gradients), once a process: the planted faults reuse it."""
    rng = np.random.default_rng(0)
    B, L, Din, H = 4, 5, 6, 7
    trees = random_trees(B, L, rng)
    n = trees.shape[1]
    trees[1, n - 1] = [n, 2, 0]   # a child at its own row: zeros
    trees[2, n - 2] = [1, 30, 0]  # a child past the last row: clamped
    emb = rng.normal(size=(B, L, Din)).astype(np.float32)
    cot = rng.normal(size=(B, n, H)).astype(np.float32)
    jm = jnn.BinaryTreeLSTM(Din, H)
    params, state = jm.init(jax.random.PRNGKey(0))

    def loss(p, e):
        o, _ = jm.apply(p, state, (e, jnp.asarray(trees)))
        return jnp.sum(o * cot), o

    (_, want), (gp, ge) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(emb))
    return trees, emb, cot, params, want, gp, ge


def _tree_reading(port=None):
    Din, H = 6, 7
    trees, emb, cot, params, want, gp, ge = _tree_reference()
    pm = load_jax_params(port or nn.BinaryTreeLSTM(Din, H),
                         jax.tree_util.tree_map(np.asarray, params))
    for p in pm.parameters():
        p.requires_grad_(True)
    e = t(emb).requires_grad_(True)
    out = pm((e, t(trees)))
    (out * t(cot)).sum().backward()
    got_gp = jax_tree(pm, {k: p.grad for k, p in pm.named_parameters()})
    pairs = [(out.detach().numpy(), np.asarray(want)),
             (e.grad.numpy(), np.asarray(ge))]
    pairs += [(got_gp[k][w].numpy(), np.asarray(gp[k][w]))
              for k in gp for w in gp[k]]
    worst = max(float(np.abs(g - w).max() / np.abs(w).max())
                for g, w in pairs)
    ok = all(np.allclose(g, w, **TREE_TOL) for g, w in pairs)
    return worst, ok


def test_binary_tree_lstm_matches_reference():
    worst, ok = _tree_reading()
    assert ok and worst < 1e-5, worst


class SwappedSides(nn.BinaryTreeLSTM):
    def _compose(self, lc, lh, rc, rh):
        return super()._compose(rc, rh, lc, lh)


class UnscheduledChildren(nn.BinaryTreeLSTM):
    """Reads every composer's children before any composer is done (one
    level for all)."""

    def forward(self, x):
        real = T.tree_plan

        def one_level(trees, n_leaves):
            slots, rows, levels = real(trees, n_leaves)
            if not levels:
                return slots, rows, levels
            return slots, rows, [tuple(np.concatenate(parts) for parts in
                                       zip(*levels))]
        T.tree_plan = one_level
        try:
            return super().forward(x)
        finally:
            T.tree_plan = real


@pytest.mark.parametrize("fault", [SwappedSides, UnscheduledChildren])
def test_tree_planted_faults_exceed_the_tolerance(fault):
    worst, ok = _tree_reading(fault(6, 7))
    assert not ok and worst > FAULT_FLOOR, worst


def test_tree_weights_cross_with_the_reference_tree():
    params, _ = jnn.BinaryTreeLSTM(4, 3).init(jax.random.PRNGKey(1))
    from bigdl_tpu_torch.interop import to_jax_params
    got, state = to_jax_params(nn.BinaryTreeLSTM(4, 3).initialize(0))
    assert state == {} or all(v == {} for v in state.values())
    assert sorted(got) == sorted(params)
    for k in params:
        assert {w: got[k][w].shape for w in got[k]} == \
            {w: np.asarray(params[k][w]).shape for w in params[k]}
