"""Object-detection heads (port of ``bigdl_tpu/nn/detection.py``): box
utilities, greedy NMS, ``Anchor``, ``PriorBox``, ``Proposal``,
``RoiPooling``, ``DetectionOutputSSD`` and ``DetectionOutputFrcnn``, the
Faster R-CNN and SSD head family.

Outputs keep the reference's static shapes: NMS returns ``(indices,
valid)`` of ``max_output`` slots (index -1 where a slot is unused), the
heads zero-padded detections and a valid mask.

NMS runs as tensor programs, with no Python loop over images or classes:
:func:`nms_rows` runs the greedy loop (``max_output`` trips, each an
argmax, the chosen box's IoU row and a suppression) over a batch of rows
at once, one row an (image, class) pair, over every box of the row as
the reference does (first index on ties, every slot after the last live
box unused).  The IoU rows are computed a trip at a time, so SSD300's
8732 priors need no (8732, 8732) matrix a row.

``RoiPooling`` pools each bin as a masked max over the feature map, the
reference's dense form, over chunks of RoIs so that its intermediate
stays under ``RoiPooling.chunk_bytes`` (2 GB by default).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module

_NEG = float("-inf")


# --------------------------------------------------------------- bbox utils
def bbox_transform_inv(boxes: torch.Tensor,
                       deltas: torch.Tensor) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) deltas against (x1, y1, x2, y2) boxes."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    dx, dy, dw, dh = deltas.unbind(-1)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


def clip_boxes(boxes: torch.Tensor, im_h, im_w) -> torch.Tensor:
    """Clip (x1, y1, x2, y2) boxes to the image (bounds may be 0-d
    tensors)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    hi_w = torch.as_tensor(im_w, dtype=boxes.dtype,
                           device=boxes.device) - 1.0
    hi_h = torch.as_tensor(im_h, dtype=boxes.dtype,
                           device=boxes.device) - 1.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([torch.clamp(x1, zero, hi_w),
                        torch.clamp(y1, zero, hi_h),
                        torch.clamp(x2, zero, hi_w),
                        torch.clamp(y2, zero, hi_h)], -1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) and (..., M, 4) corner boxes, the +1
    pixel convention of the reference's areas."""
    area_a = ((a[..., 2] - a[..., 0] + 1.0)
              * (a[..., 3] - a[..., 1] + 1.0))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0] + 1.0)
              * (b[..., 3] - b[..., 1] + 1.0))[..., None, :]
    ix = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0]) + 1.0)
    iy = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1]) + 1.0)
    inter = torch.clamp(ix, min=0.0) * torch.clamp(iy, min=0.0)
    return inter / (area_a + area_b - inter)


# ---------------------------------------------------------------------- NMS
def _greedy(scores: torch.Tensor, thresh: float, max_output: int, iou_rows):
    """The greedy loop over rows: ``scores`` (R, N) with -inf for dead
    candidates, ``iou_rows(best)`` the (R, N) IoU of each row's chosen box
    with the row's boxes.  (indices (R, max_output), -1 where unused;
    valid (R, max_output))."""
    R, N = scores.shape
    dev = scores.device
    live = scores.float().clone()
    cols = torch.arange(N, device=dev)
    idx = torch.full((R, max_output), -1, dtype=torch.long, device=dev)
    valid = torch.zeros((R, max_output), dtype=torch.bool, device=dev)
    for i in range(max_output):
        best = live.argmax(1)  # the first of equal maxima
        ok = live.gather(1, best[:, None])[:, 0] > _NEG
        idx[:, i] = torch.where(ok, best, -1)
        valid[:, i] = ok
        suppress = (iou_rows(best) > thresh) | (cols[None] == best[:, None])
        live = torch.where(ok[:, None] & suppress, _NEG, live)
    return idx, valid


def nms_rows(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
             max_output: int):
    """Greedy NMS of each row: ``boxes`` (R, N, 4) or (N, 4) shared by
    the rows, ``scores`` (R, N).  Returns ``(indices (R, max_output),
    valid (R, max_output))``, indices into N (-1 where unused), each row
    the reference's :func:`nms` of its boxes and scores.  A trip takes the
    chosen box's IoU row of every row, (R, N), as the reference's row of
    its (N, N) matrix (the same operations on the same values), so no
    (N, N) matrix is made."""
    R, N = scores.shape
    if boxes.dim() == 2:
        boxes = boxes.expand(R, N, 4)

    def iou_rows(best):
        chosen = boxes.gather(1, best[:, None, None].expand(R, 1, 4))
        return box_iou(chosen, boxes)[:, 0]

    return _greedy(scores, thresh, max_output, iou_rows)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: int, iou: Optional[torch.Tensor] = None):
    """Greedy NMS with a static output: ``(indices (max_output,), valid
    (max_output,))``, ``indices`` int32 as the reference's, -1 where a
    slot is unused.  ``iou`` passes a precomputed pairwise IoU of
    ``boxes``."""
    if iou is None:
        idx, valid = nms_rows(boxes, scores[None], iou_threshold,
                              max_output)
    else:
        idx, valid = _greedy(scores[None], iou_threshold, max_output,
                             lambda best: iou[best])
    return idx[0].to(torch.int32), valid[0]


class Nms:
    """Object-style wrapper (the reference's ``Nms`` API)."""

    def __call__(self, scores, boxes, thresh: float, max_output: int):
        return nms(boxes, scores, thresh, max_output)


# ------------------------------------------------------------------- Anchor
class Anchor:
    """Faster R-CNN anchors: ratios x scales around a ``base_size`` box,
    shifted over the feature-map grid."""

    def __init__(self, ratios: Sequence[float], scales: Sequence[float],
                 base_size: int = 16):
        self.ratios = list(ratios)
        self.scales = list(scales)
        self.base_size = base_size
        self.anchor_num = len(ratios) * len(scales)
        self.basic_anchors = self._generate_basic()  # (A, 4) numpy

    def _generate_basic(self) -> np.ndarray:
        """Ratio enumeration, then scale enumeration, rounding as the
        reference does."""
        base = np.array([0.0, 0.0, self.base_size - 1.0,
                         self.base_size - 1.0])
        w = base[2] - base[0] + 1
        h = base[3] - base[1] + 1
        cx = base[0] + 0.5 * (w - 1)
        cy = base[1] + 0.5 * (h - 1)
        area = w * h
        out = []
        for r in self.ratios:
            ws = round(math.sqrt(area / r))
            hs = round(ws * r)
            for s in self.scales:
                wss, hss = ws * s, hs * s
                out.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
        return np.asarray(out, np.float32)

    def generate_anchors(self, width: int, height: int,
                         feat_stride: float = 16.0,
                         device=None) -> torch.Tensor:
        """Every anchor of a (height, width) map: (H*W*A, 4), shifts x
        fastest, then y, each cell's A anchors together."""
        f32 = dict(dtype=torch.float32, device=device)
        sx = torch.arange(width, **f32) * feat_stride
        sy = torch.arange(height, **f32) * feat_stride
        shift_x, shift_y = torch.meshgrid(sx, sy, indexing="xy")
        shifts = torch.stack([shift_x, shift_y, shift_x, shift_y],
                             -1).reshape(-1, 4)
        a = torch.as_tensor(self.basic_anchors, **f32)
        return (shifts[:, None, :] + a[None]).reshape(-1, 4)


# ----------------------------------------------------------------- PriorBox
class PriorBox(Module):
    """SSD prior boxes of one feature map, Caffe's layout ``(1, 2,
    H*W*P*4)``: row 0 the normalized priors, row 1 their variances."""

    def __init__(self, min_sizes: Sequence[float],
                 max_sizes: Optional[Sequence[float]] = None,
                 aspect_ratios: Optional[Sequence[float]] = None,
                 is_flip: bool = True, is_clip: bool = False,
                 variances: Optional[Sequence[float]] = None,
                 offset: float = 0.5,
                 img_h: int = 0, img_w: int = 0, img_size: int = 0,
                 step_h: float = 0.0, step_w: float = 0.0, step: float = 0.0,
                 name: Optional[str] = None):
        super().__init__(name)
        self.min_sizes = list(min_sizes)
        self.max_sizes = list(max_sizes or [])
        ars = [1.0]
        for ar in (aspect_ratios or []):
            if any(abs(ar - e) < 1e-6 for e in ars):
                continue
            ars.append(ar)
            if is_flip:
                ars.append(1.0 / ar)
        self.aspect_ratios = ars
        self.is_clip = is_clip
        self.variances = list(variances or [0.1])
        self.offset = offset
        self.img_h, self.img_w = (img_h or img_size), (img_w or img_size)
        self.step_h, self.step_w = (step_h or step), (step_w or step)
        self.n_priors = (len(self.min_sizes) * len(self.aspect_ratios)
                         + len(self.max_sizes))

    def forward(self, x):
        # x: the feature map (N, C, H, W); only its H and W are read
        fh, fw = x.shape[2], x.shape[3]
        img_h, img_w = self.img_h, self.img_w
        step_h = self.step_h or img_h / fh
        step_w = self.step_w or img_w / fw
        widths, heights = [], []
        for ms in self.min_sizes:
            for ar in self.aspect_ratios:
                if abs(ar - 1.0) < 1e-6:
                    widths.append(ms)
                    heights.append(ms)
                else:
                    widths.append(ms * math.sqrt(ar))
                    heights.append(ms / math.sqrt(ar))
            if self.max_sizes:
                mx = self.max_sizes[self.min_sizes.index(ms)]
                widths.append(math.sqrt(ms * mx))
                heights.append(math.sqrt(ms * mx))
        f32 = dict(dtype=torch.float32, device=x.device)
        w = torch.tensor(widths, **f32) * 0.5
        h = torch.tensor(heights, **f32) * 0.5
        cx = (torch.arange(fw, **f32) + self.offset) * step_w
        cy = (torch.arange(fh, **f32) + self.offset) * step_h
        gx, gy = torch.meshgrid(cx, cy, indexing="xy")  # (fh, fw)
        centers = torch.stack([gx, gy], -1).reshape(-1, 2)
        # tensor divisors: the same true division on the card and the CPU
        iw = torch.full((1,), float(img_w), **f32)
        ih = torch.full((1,), float(img_h), **f32)
        x1 = (centers[:, None, 0] - w[None]) / iw
        y1 = (centers[:, None, 1] - h[None]) / ih
        x2 = (centers[:, None, 0] + w[None]) / iw
        y2 = (centers[:, None, 1] + h[None]) / ih
        priors = torch.stack([x1, y1, x2, y2], -1)
        if self.is_clip:
            priors = torch.clamp(priors, 0.0, 1.0)
        flat = priors.reshape(-1)
        if len(self.variances) == 1:
            var = torch.full_like(flat, self.variances[0])
        else:
            var = torch.tensor(self.variances, **f32).repeat(
                flat.shape[0] // 4)
        return torch.stack([flat, var])[None]


def _top_sorted(scores: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, in descending order, equal
    values in index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ----------------------------------------------------------------- Proposal
class Proposal(Module):
    """The RPN's proposal layer.  Input ``(scores (1, 2A, H, W),
    bbox_deltas (1, 4A, H, W), im_info (1, >=4) = [im_h, im_w, scale_h,
    scale_w])``; output ``(boxes (post_nms_topn, 5), valid
    (post_nms_topn,))``, column 0 the batch index (0: one image), rows
    past the kept proposals zero."""

    def __init__(self, pre_nms_topn: int, post_nms_topn: int,
                 ratios: Sequence[float], scales: Sequence[float],
                 min_size: int = 16, nms_thresh: float = 0.7,
                 feat_stride: float = 16.0, name: Optional[str] = None):
        super().__init__(name)
        self.pre_nms_topn = pre_nms_topn
        self.post_nms_topn = post_nms_topn
        self.anchor = Anchor(ratios, scales)
        self.min_size = min_size
        self.nms_thresh = nms_thresh
        self.feat_stride = feat_stride

    def decode(self, x):
        """(every anchor's proposal box (H*W*A, 4), clipped; its
        foreground score, -inf under the minimum size)."""
        scores, deltas, im_info = x
        A = self.anchor.anchor_num
        H, W = scores.shape[2], scores.shape[3]
        fg = scores[0, A:].permute(1, 2, 0).reshape(-1)  # anchor order
        d = deltas[0].reshape(A, 4, H, W).permute(2, 3, 0, 1).reshape(-1, 4)
        anchors = self.anchor.generate_anchors(W, H, self.feat_stride,
                                               device=scores.device)
        proposals = clip_boxes(bbox_transform_inv(anchors, d),
                               im_info[0, 0], im_info[0, 1])
        # boxes under min_size * the image's scale drop out of the ranking
        ws = proposals[:, 2] - proposals[:, 0] + 1.0
        hs = proposals[:, 3] - proposals[:, 1] + 1.0
        keep = (ws >= self.min_size * im_info[0, 3]) \
            & (hs >= self.min_size * im_info[0, 2])
        return proposals, torch.where(keep, fg, _NEG)

    def select(self, proposals, fg):
        """The best ``pre_nms_topn`` by score, suppressed to
        ``post_nms_topn``: ``(boxes, valid)``."""
        top_scores, top_idx = _top_sorted(fg, min(self.pre_nms_topn,
                                                  fg.shape[0]))
        top_boxes = proposals[top_idx]
        idx, valid = nms(top_boxes, top_scores, self.nms_thresh,
                         self.post_nms_topn)
        out = torch.cat([top_boxes.new_zeros((self.post_nms_topn, 1)),
                         top_boxes[idx.clamp(min=0)]], 1)
        return out * valid[:, None].to(out.dtype), valid

    def forward(self, x):
        return self.select(*self.decode(x))


# --------------------------------------------------------------- RoiPooling
class RoiPooling(Module):
    """RoI max pooling.  Input ``(data (N, C, H, W), rois (R, 5) =
    [batch_index, x1, y1, x2, y2])``; output ``(R, C, pooled_h,
    pooled_w)``, an empty bin 0.  Each bin is a masked max over the map,
    rows then columns, over chunks of RoIs whose intermediate stays
    under ``chunk_bytes``."""

    chunk_bytes = 2 << 30

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float,
                 name: Optional[str] = None):
        super().__init__(name)
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    def _bins(self, rois, H, W):
        s = self.spatial_scale
        x1, y1, x2, y2 = (torch.round(rois[:, k] * s) for k in (1, 2, 3, 4))
        f32 = dict(dtype=torch.float32, device=rois.device)
        # a tensor divisor: CUDA divides by a Python number as a product
        # with its reciprocal, which can move a bin edge across an integer
        bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / torch.full(
            (1,), float(self.pooled_w), **f32)
        bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / torch.full(
            (1,), float(self.pooled_h), **f32)
        ph = torch.arange(self.pooled_h, **f32)
        pw = torch.arange(self.pooled_w, **f32)
        hs = torch.clamp(torch.floor(ph[None] * bin_h[:, None]) + y1[:, None],
                         0, H)
        he = torch.clamp(torch.ceil((ph[None] + 1) * bin_h[:, None])
                         + y1[:, None], 0, H)
        ws = torch.clamp(torch.floor(pw[None] * bin_w[:, None]) + x1[:, None],
                         0, W)
        we = torch.clamp(torch.ceil((pw[None] + 1) * bin_w[:, None])
                         + x1[:, None], 0, W)
        gy = torch.arange(H, **f32)
        gx = torch.arange(W, **f32)
        mask_h = (gy[None, None] >= hs[..., None]) \
            & (gy[None, None] < he[..., None])  # (R, ph, H)
        mask_w = (gx[None, None] >= ws[..., None]) \
            & (gx[None, None] < we[..., None])  # (R, pw, W)
        return mask_h, mask_w

    def _pool(self, data, rois):
        H, W = data.shape[2], data.shape[3]
        feats = data[rois[:, 0].long()]  # (r, C, H, W)
        mask_h, mask_w = self._bins(rois, H, W)
        neg = torch.tensor(_NEG, dtype=data.dtype, device=data.device)
        rows = torch.where(mask_h[:, None, :, :, None], feats[:, :, None],
                           neg).amax(3)  # (r, C, ph, W)
        out = torch.where(mask_w[:, None, None], rows[:, :, :, None],
                          neg).amax(-1)  # (r, C, ph, pw)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

    def forward(self, x):
        data, rois = x
        C, H, W = data.shape[1:]
        per_roi = (self.pooled_h + 1) * C * H * W * data.element_size()
        chunk = max(1, self.chunk_bytes // per_roi)
        if rois.shape[0] <= chunk:
            return self._pool(data, rois)
        return torch.cat([self._pool(data, rois[i:i + chunk])
                          for i in range(0, rois.shape[0], chunk)])


def _global_topk(dets: torch.Tensor, valid: torch.Tensor, k: int):
    """The ``k`` best rows of ``(dets (..., M, 6), valid (..., M))`` by
    score (column 1), zero-padded to ``k`` (the SSD and Faster R-CNN
    heads' last cut)."""
    masked = torch.where(valid, dets[..., 1], _NEG)
    kk = min(k, masked.shape[-1])
    top_s, top_i = _top_sorted(masked, kk)
    out = dets.gather(-2, top_i[..., None].expand(*top_i.shape, 6))
    out_valid = torch.isfinite(top_s)
    out = out * out_valid[..., None].to(out.dtype)
    if kk < k:
        pad = list(out.shape)
        pad[-2] = k - kk
        out = torch.cat([out, out.new_zeros(pad)], -2)
        out_valid = torch.cat([out_valid, out_valid.new_zeros(pad[:-1])],
                              -1)
    return out, out_valid


def _class_dets(boxes, scores, idx, valid, labels):
    """(rows, per_class, 6) detections [label, score, box] of rows of
    NMS results over ``boxes`` (rows, N, 4) and ``scores`` (rows, N)."""
    at = idx.clamp(min=0)
    b = boxes.gather(1, at[..., None].expand(*at.shape, 4))
    sc = scores.gather(1, at)
    lab = labels[:, None].expand_as(sc).to(sc.dtype)
    return torch.cat([lab[..., None], sc[..., None], b], -1)


# ------------------------------------------------------- DetectionOutputSSD
class DetectionOutputSSD(Module):
    """SSD post-processing.  Input ``(loc (N, P*4), conf (N,
    P*n_classes), priors (1, 2, P*4))``; output ``(dets (N, keep_topk, 6)
    = [label, score, x1, y1, x2, y2], valid (N, keep_topk))``: the
    priors decoded Caffe's way, each class but the background suppressed
    to ``nms_topk // (n_classes - 1)`` boxes (all images and classes in
    one batched NMS), then the best ``keep_topk`` of an image."""

    def __init__(self, n_classes: int = 21, share_location: bool = True,
                 bg_label: int = 0, nms_thresh: float = 0.45,
                 nms_topk: int = 400, keep_topk: int = 200,
                 conf_thresh: float = 0.01,
                 variance_encoded_in_target: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        if not share_location:
            raise NotImplementedError("share_location=False not supported")
        self.n_classes = n_classes
        self.bg_label = bg_label
        self.nms_thresh = nms_thresh
        self.nms_topk = nms_topk
        self.keep_topk = keep_topk
        self.conf_thresh = conf_thresh
        self.variance_encoded = variance_encoded_in_target

    def _decode(self, loc, priors, variances):
        """Caffe's center-size decode of (..., P, 4) offsets."""
        pw = priors[:, 2] - priors[:, 0]
        ph = priors[:, 3] - priors[:, 1]
        pcx = (priors[:, 0] + priors[:, 2]) * 0.5
        pcy = (priors[:, 1] + priors[:, 3]) * 0.5
        v = torch.ones_like(loc) if self.variance_encoded \
            else variances.expand_as(loc)
        cx = v[..., 0] * loc[..., 0] * pw + pcx
        cy = v[..., 1] * loc[..., 1] * ph + pcy
        w = torch.exp(v[..., 2] * loc[..., 2]) * pw
        h = torch.exp(v[..., 3] * loc[..., 3]) * ph
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)

    def decode(self, loc, priors):
        """Every image's decoded prior boxes, (N, P, 4)."""
        N, P = loc.shape[0], priors.shape[2] // 4
        return self._decode(loc.reshape(N, P, 4), priors[0, 0].reshape(P, 4),
                            priors[0, 1].reshape(P, 4))

    def forward(self, x):
        loc, conf, priors = x
        return self.select(self.decode(loc, priors), conf)

    def select(self, boxes, conf):
        """Per-class NMS of decoded ``boxes`` (N, P, 4) by ``conf`` (N,
        P*n_classes), then each image's best ``keep_topk``: ``(dets,
        valid)``."""
        N, P = boxes.shape[:2]
        scores = conf.reshape(N, P, self.n_classes)
        classes = [c for c in range(self.n_classes) if c != self.bg_label]
        per_class = max(1, self.nms_topk // max(1, self.n_classes - 1))
        cls = torch.tensor(classes, device=boxes.device)
        s = scores[:, :, cls].permute(0, 2, 1)  # (N, C', P)
        s = torch.where(s >= self.conf_thresh, s, _NEG)
        rows = N * len(classes)
        row_boxes = boxes[:, None].expand(N, len(classes), P, 4) \
            .reshape(rows, P, 4)
        idx, valid = nms_rows(row_boxes, s.reshape(rows, P),
                              self.nms_thresh, per_class)
        raw = scores.permute(0, 2, 1)[:, cls].reshape(rows, P)
        dets = _class_dets(row_boxes, raw, idx, valid, cls.repeat(N))
        dets = dets.reshape(N, len(classes) * per_class, 6)
        return _global_topk(dets, valid.reshape(N, -1), self.keep_topk)


# --------------------------------------------------- DetectionOutputFrcnn
class DetectionOutputFrcnn(Module):
    """Faster R-CNN post-processing.  Input ``(im_info (1, >=4), rois (R,
    5) [batch, x1, y1, x2, y2], bbox_deltas (R, 4*n_classes), scores (R,
    n_classes))``; output ``(dets (max_per_image, 6) = [label, score, x1,
    y1, x2, y2], valid (max_per_image,))``: every class but 0 with its own
    box regression, clipped, its scores above ``thresh``, suppressed at
    ``nms_thresh`` (all classes in one batched NMS), then the best
    ``max_per_image``."""

    def __init__(self, nms_thresh: float = 0.3, n_classes: int = 21,
                 max_per_image: int = 100, thresh: float = 0.05,
                 name: Optional[str] = None):
        super().__init__(name)
        self.nms_thresh = nms_thresh
        self.n_classes = n_classes
        self.max_per_image = max_per_image
        self.thresh = thresh

    def decode(self, im_info, rois, deltas):
        """Each class's regressed and clipped boxes, (n_classes - 1, R,
        4)."""
        R = rois.shape[0]
        d = deltas.reshape(R, self.n_classes, 4)[:, 1:].permute(1, 0, 2)
        return clip_boxes(bbox_transform_inv(rois[None, :, 1:5], d),
                          im_info[0, 0], im_info[0, 1])

    def forward(self, x):
        im_info, rois, deltas, scores = x
        return self.select(self.decode(im_info, rois, deltas), scores)

    def select(self, decoded, scores):
        """Per-class NMS of ``decoded`` by ``scores`` (R, n_classes), then
        the best ``max_per_image``: ``(dets, valid)``."""
        C, R = decoded.shape[:2]
        raw = scores[:, 1:].T  # (C, R)
        s = torch.where(raw > self.thresh, raw, _NEG)
        per_class = min(R, self.max_per_image)
        idx, valid = nms_rows(decoded, s, self.nms_thresh, per_class)
        labels = torch.arange(1, self.n_classes, device=decoded.device)
        dets = _class_dets(decoded, raw, idx, valid, labels)
        return _global_topk(dets.reshape(C * per_class, 6),
                            valid.reshape(-1), self.max_per_image)
