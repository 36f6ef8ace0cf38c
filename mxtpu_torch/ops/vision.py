"""Vision and detection ops of the PyTorch port.

Counterpart of ``mxtpu/ops/vision.py``, under the same registry names and
aliases: ROI and position-sensitive ROI pooling, SSD's MultiBoxPrior /
MultiBoxTarget / MultiBoxDetection, the RPN's Proposal and
MultiProposal, bilinear sampling (BilinearSampler, GridGenerator,
SpatialTransformer), Correlation and the sequence ops. Each is written
batched in torch where ``mxtpu`` maps a function over the batch with
``vmap``; the arithmetic is ``mxtpu``'s, in the same order.

``mxtpu`` runs non-maximum suppression as a ``lax.fori_loop`` over the
score-sorted boxes (``vision.py:305-312`` for MultiBoxDetection, the same
loop in Proposal). A loop of torch calls would launch some 40,000
kernels an image at SSD-300's 8,732 anchors, so here it is one
hand-written kernel, :func:`multibox_nms` (``csrc/vision.cu``); its plain
version, :func:`multibox_nms_plain`, is that loop in torch, and runs for
a tensor on the CPU. Neither builds the A x A IoU matrix that ``mxtpu``
builds inside its ``vmap``: each computes a row's IoU when it needs it.

The order of tied scores decides the rows' order (most scores are 0
after the threshold), so every sort here is stable, as ``jnp.argsort``
is; and where two ground-truth boxes force-match one anchor, the later
box wins, as JAX's scatter resolves it on the CPU.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .registry import register

# launches of each kernel of this module (see multibox_nms)
LAUNCHES = {"multibox_nms": 0}

# a block of the NMS kernel: one image; its threads split the boxes after
# the current one
NMS_THREADS = 1024
# dynamic shared memory a block may take on sm_90 (227 KB)
NMS_SMEM_LIMIT = 232448


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _grid(n, dtype, device):
    return torch.arange(n, dtype=dtype, device=device)


def _scalars(values, device):
    """float32 0-d tensors of ``values`` on ``device``, each made by a fill
    there: a copy from pageable host memory would make the host wait for
    the card's queue. (A divisor stays a tensor, as ``mxtpu``'s
    variances are an array: torch divides by a Python number on the card
    as a product with its reciprocal.)"""
    return [torch.full((), float(v), dtype=torch.float32, device=device)
            for v in values]


# ---------------------------------------------------------------------------
# ROI pooling
# ---------------------------------------------------------------------------

def _bin_masks(start, end, extent):
    """[R, P, extent] masks of the pixels in [start, end) of each bin."""
    pos = _grid(extent, torch.float32, start.device)
    return (pos >= start[..., None]) & (pos < end[..., None])


@register("ROIPooling", aliases=("roi_pooling",))
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max-pool each ROI into a fixed (PH, PW) grid. data [N, C, H, W];
    rois [R, 5] of (batch_idx, x1, y1, x2, y2) in image coordinates. Bins
    with no pixels give 0."""
    ph, pw = _pair(pooled_size)
    _n, _c, h, w = data.shape
    rois = rois.to(torch.float32)
    bidx = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (torch.round(rois[:, k] * spatial_scale)
                      for k in (1, 2, 3, 4))
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / pw
    p = _grid(ph, torch.float32, data.device)
    q = _grid(pw, torch.float32, data.device)
    hstart = torch.clamp(torch.floor(p * bin_h[:, None]) + y1[:, None], 0, h)
    hend = torch.clamp(torch.ceil((p + 1) * bin_h[:, None]) + y1[:, None],
                       0, h)
    wstart = torch.clamp(torch.floor(q * bin_w[:, None]) + x1[:, None], 0, w)
    wend = torch.clamp(torch.ceil((q + 1) * bin_w[:, None]) + x1[:, None],
                       0, w)
    mask_h = _bin_masks(hstart, hend, h)          # [R, PH, H]
    mask_w = _bin_masks(wstart, wend, w)          # [R, PW, W]
    mask = mask_h[:, :, None, :, None] & mask_w[:, None, :, None, :]
    img = data[bidx]                              # [R, C, H, W]
    neg = torch.finfo(data.dtype).min
    vals = torch.where(mask[:, None], img[:, :, None, None], neg)
    out = torch.amax(vals, dim=(-1, -2))          # [R, C, PH, PW]
    empty = ~mask.any(dim=-1).any(dim=-1)
    return torch.where(empty[:, None], 0.0, out).to(data.dtype)


@register("_contrib_PSROIPooling", aliases=("psroi_pooling",))
def psroi_pooling(data, rois, spatial_scale=1.0, output_dim=1, pooled_size=7,
                  group_size=0):
    """Position-sensitive ROI pooling (R-FCN): channel k*(i*P+j)
    average-pools bin (i, j)."""
    p = int(pooled_size)
    group = int(group_size) if group_size else p
    _n, c, h, w = data.shape
    assert c == output_dim * group * group, "channels != output_dim*group^2"
    rois = rois.to(torch.float32)
    r = rois.shape[0]
    bidx = rois[:, 0].to(torch.int64)
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 4] + 1.0) * spatial_scale
    bin_h = torch.clamp(y2 - y1, min=0.1) / p
    bin_w = torch.clamp(x2 - x1, min=0.1) / p
    img = data[bidx].reshape(r, output_dim, group, group, h, w)
    k = _grid(p, torch.float32, data.device)
    hstart = torch.clamp(torch.floor(k * bin_h[:, None] + y1[:, None]), 0, h)
    hend = torch.clamp(torch.ceil((k + 1) * bin_h[:, None] + y1[:, None]),
                       0, h)
    wstart = torch.clamp(torch.floor(k * bin_w[:, None] + x1[:, None]), 0, w)
    wend = torch.clamp(torch.ceil((k + 1) * bin_w[:, None] + x1[:, None]),
                       0, w)
    mask = _bin_masks(hstart, hend, h)[:, :, None, :, None] & \
        _bin_masks(wstart, wend, w)[:, None, :, None, :]   # [R, P, P, H, W]
    gi = torch.floor(k * group / p).to(torch.int64)
    img_bins = img[:, :, gi][:, :, :, gi]                # [R, D, P, P, H, W]
    s = torch.where(mask[:, None], img_bins, 0.0).sum(dim=(-1, -2))
    cnt = torch.clamp(mask.sum(dim=(-1, -2)), min=1)
    return (s / cnt[:, None]).to(data.dtype)


# ---------------------------------------------------------------------------
# SSD: MultiBoxPrior / MultiBoxTarget / MultiBoxDetection
# ---------------------------------------------------------------------------

def _parse_floats(v, default):
    if v is None:
        return list(default)
    if isinstance(v, (int, float)):
        return [float(v)]
    return [float(x) for x in v]


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",
                                             "multibox_prior"),
          differentiable=False)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD's anchor boxes for a feature map [1, H*W*A, 4]: a cell's
    anchors are all sizes at ratios[0], then sizes[0] at ratios[1:]
    (num_anchors = len(sizes) + len(ratios) - 1); a width carries the
    h/w correction, so anchors are square in pixels."""
    sizes = _parse_floats(sizes, (1.0,))
    ratios = _parse_floats(ratios, (1.0,))
    h, w = data.shape[-2], data.shape[-1]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (_grid(h, torch.float32, dev) + offsets[0]) * step_y
    cx = (_grid(w, torch.float32, dev) + offsets[1]) * step_x
    aspect = float(h) / float(w)
    combos = [(s, ratios[0]) for s in sizes] + \
             [(sizes[0], r) for r in ratios[1:]]
    ws = torch.stack(_scalars([s * aspect * r ** 0.5 for s, r in combos],
                              dev)) / 2
    hs = torch.stack(_scalars([s / r ** 0.5 for s, r in combos], dev)) / 2
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cxg, cyg], -1).reshape(-1, 1, 2)   # [HW, 1, 2]
    half = torch.stack([ws, hs], -1)                          # [A, 2]
    anchors = torch.cat([centers - half[None], centers + half[None]],
                        -1).reshape(1, -1, 4)
    if clip:
        anchors = torch.clamp(anchors, 0.0, 1.0)
    return anchors


def _corner_iou(a, b):
    """IoU of [..., 4] corner boxes, broadcasting leading dims."""
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return torch.clamp(x[..., 2] - x[..., 0], min=0) * \
            torch.clamp(x[..., 3] - x[..., 1], min=0)

    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union, 0.0)


def _box_iou(a, b):
    """IoU matrix between corner boxes a [M, 4] and b [N, 4]."""
    return _corner_iou(a[:, None, :], b[None, :, :])


def _stable_rank(score):
    """Each entry's place in its row sorted by ``score`` descending, ties
    in index order (``argsort(argsort(-score))`` with a stable sort)."""
    order = torch.argsort(-score, dim=-1, stable=True)
    rank = torch.empty_like(order)
    return rank.scatter_(-1, order, _grid(score.shape[-1], order.dtype,
                                          order.device).expand_as(order))


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",
                                              "multibox_target"),
          differentiable=False, num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth and emit the training targets:
    (box_target [B, A*4], box_mask [B, A*4], cls_target [B, A]). A label
    row is (class_id, x1, y1, x2, y2); class -1 pads. Each valid box
    force-matches its best anchor (the later box where two share one);
    the other anchors match their best box at IoU >= overlap_threshold.
    With ``negative_mining_ratio`` > 0, the unmatched anchors under
    ``negative_mining_thresh`` are ranked by their most confident
    non-background prediction and the ratio x positives hardest kept as
    background; the rest get ``ignore_label``."""
    anchors = anchor.detach().to(torch.float32).reshape(-1, 4)
    label = label.detach().to(torch.float32)
    preds = cls_pred.detach().to(torch.float32)
    num_anchors = anchors.shape[0]
    b, g = label.shape[0], label.shape[1]
    dev = anchors.device
    v = _scalars(variances, dev)
    valid = label[..., 0] >= 0                                  # [B, G]
    gt = label[..., 1:5]
    iou = _corner_iou(anchors[None, :, None, :], gt[:, None, :, :])
    iou = torch.where(valid[:, None, :], iou, -1.0)            # [B, A, G]
    best_gt = torch.argmax(iou, dim=2)
    best_iou = torch.amax(iou, dim=2)
    matched = best_iou >= overlap_threshold
    # bipartite: the best anchor of each valid box is forced to it; a
    # padding row forces nothing, and of two boxes sharing an anchor the
    # later one wins (JAX's scatter on the CPU)
    best_anchor = torch.argmax(iou, dim=1)                     # [B, G]
    hit = valid[:, :, None] & (
        best_anchor[:, :, None] == _grid(num_anchors, torch.int64, dev))
    forced_gt = torch.where(hit, _grid(g, torch.int64, dev)[None, :, None],
                            -1).amax(dim=1) if g else \
        torch.full((b, num_anchors), -1, dtype=torch.int64, device=dev)
    forced = forced_gt >= 0
    m_gt = torch.where(forced, forced_gt, best_gt)
    matched = matched | forced
    box = torch.gather(gt, 1, m_gt[..., None].expand(b, num_anchors, 4))
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-8)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-8)
    gcx = (box[..., 0] + box[..., 2]) / 2
    gcy = (box[..., 1] + box[..., 3]) / 2
    gw = torch.clamp(box[..., 2] - box[..., 0], min=1e-8)
    gh = torch.clamp(box[..., 3] - box[..., 1], min=1e-8)
    box_t = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                         torch.log(gw / aw) / v[2],
                         torch.log(gh / ah) / v[3]], -1)
    box_t = torch.where(matched[..., None], box_t, 0.0).reshape(b, -1)
    box_m = matched[..., None].expand(b, num_anchors, 4).to(
        torch.float32).reshape(b, -1)
    cls_t = torch.where(matched, torch.gather(label[..., 0], 1, m_gt) + 1.0,
                        0.0)
    if negative_mining_ratio > 0:
        cand = ~matched & (best_iou < negative_mining_thresh)
        neg_score = torch.amax(preds[:, 1:], dim=1)            # [B, A]
        rank = _stable_rank(torch.where(cand, neg_score, -math.inf))
        num_neg = matched.sum(dim=1, keepdim=True) * negative_mining_ratio
        keep_neg = cand & (rank < num_neg)
        cls_t = torch.where(matched, cls_t,
                            torch.where(keep_neg, 0.0, float(ignore_label)))
    return box_t, box_m, cls_t


def multibox_nms_plain(boxes, cls_id, nms_threshold, force_suppress, limit):
    """Greedy NMS over score-sorted rows, ``mxtpu``'s ``fori_loop``
    (``vision.py:305-315``) in torch: for each row i < ``limit`` still
    alive with a class, rows j > i of its class (any class under
    ``force_suppress``) whose IoU with i is above ``nms_threshold`` die;
    rows from ``limit`` on die too. boxes [B, A, 4], cls_id [B, A] (-1:
    none). Returns cls_id with the dead rows set to -1. The IoU of row i
    is computed at its turn: no A x A matrix."""
    num = cls_id.shape[1]
    j = _grid(num, torch.int64, cls_id.device)
    alive = torch.ones_like(cls_id, dtype=torch.bool)
    for i in range(limit):
        iou = _corner_iou(boxes[:, i:i + 1], boxes)            # [B, A]
        ci = cls_id[:, i:i + 1]
        same = (ci == cls_id) | bool(force_suppress)
        sup = (iou > nms_threshold) & same & (j > i) & \
            alive[:, i:i + 1] & (ci >= 0)
        alive = alive & ~sup
    alive = alive & (j < limit)
    return torch.where(alive, cls_id, -1.0)


def multibox_nms_smem(num):
    """(dynamic shared memory bytes, whether the boxes are kept there) of
    one block of the kernel at ``num`` rows: a chunk's survivor mask, the
    alive flags and the classes always, the boxes where they all fit."""
    def up(n):
        return (n + 15) // 16 * 16
    base = 16 + up(num) + up(4 * num)
    full = base + 16 * num
    if full <= NMS_SMEM_LIMIT:
        return full, True
    return base, False


def multibox_nms(boxes, cls_id, nms_threshold, force_suppress, limit):
    """:func:`multibox_nms_plain`'s function. A CPU tensor takes the plain
    loop; a CUDA tensor launches the kernel ``multibox_nms`` of
    ``csrc/vision.cu`` (one block an image) or raises."""
    if boxes.device.type == "cpu":
        return multibox_nms_plain(boxes, cls_id, nms_threshold,
                                  force_suppress, limit)
    if boxes.device.type != "cuda" or cls_id.device != boxes.device:
        raise ValueError("multibox_nms: boxes on %s and classes on %s; "
                         "both must be on one CUDA device"
                         % (boxes.device, cls_id.device))
    if boxes.dtype != torch.float32 or cls_id.dtype != torch.float32:
        raise TypeError("multibox_nms takes float32, got %s and %s"
                        % (boxes.dtype, cls_id.dtype))
    b, num = cls_id.shape
    if tuple(boxes.shape) != (b, num, 4):
        raise ValueError("multibox_nms: boxes %s for classes %s"
                         % (tuple(boxes.shape), tuple(cls_id.shape)))
    if not (boxes.is_contiguous() and cls_id.is_contiguous()):
        raise ValueError("multibox_nms takes contiguous tensors")
    if not 0 <= limit <= num:
        raise ValueError("multibox_nms: limit %d outside [0, %d]"
                         % (limit, num))
    smem, _ = multibox_nms_smem(num)
    if smem > NMS_SMEM_LIMIT:
        raise ValueError("multibox_nms: %d rows need %d bytes of shared "
                         "memory, more than a block has" % (num, smem))
    out = torch.empty_like(cls_id)
    if b == 0 or num == 0:
        return out
    from .. import _build
    lib = _build.load("vision")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mx_multibox_nms(
            boxes.data_ptr(), cls_id.data_ptr(), out.data_ptr(), b, num,
            int(limit), ctypes.c_float(float(nms_threshold)),
            int(bool(force_suppress)), NMS_THREADS, stream)
    if err:
        raise RuntimeError("multibox_nms launch failed: CUDA error %d" % err)
    LAUNCHES["multibox_nms"] += 1
    return out


def detection_rows(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                   background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """MultiBoxDetection before its NMS: (cls_id [B, A], score [B, A],
    boxes [B, A, 4]), contiguous float32, sorted by score (stably). The
    boxes are the decoded anchors; a row's class is its best
    non-background class (ids past ``background_id`` shifted down), -1
    with score 0 where that score is not above ``threshold``."""
    probs = cls_prob.detach().to(torch.float32)
    b = probs.shape[0]
    anchors = anchor.detach().to(torch.float32).reshape(-1, 4)
    num_anchors = anchors.shape[0]
    loc = loc_pred.detach().to(torch.float32).reshape(b, num_anchors, 4)
    v = _scalars(variances, anchors.device)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    bw = torch.exp(loc[..., 2] * v[2]) * aw / 2
    bh = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - bw, cy - bh, cx + bw, cy + bh], -1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    masked = probs.clone()
    masked[:, background_id] = -1.0
    cls_id = torch.argmax(masked, dim=1).to(torch.float32)     # [B, A]
    score = torch.amax(masked, dim=1)
    keep = score > threshold
    cls_id = torch.where(keep, cls_id - (cls_id > background_id).to(
        torch.float32), -1.0)
    score = torch.where(keep, score, 0.0)
    order = torch.argsort(-score, dim=1, stable=True)
    return (torch.gather(cls_id, 1, order), torch.gather(score, 1, order),
            torch.gather(boxes, 1, order[..., None].expand(
                b, num_anchors, 4)).contiguous())


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",
                                                 "multibox_detection"),
          differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode predictions into detections with per-class NMS: [B, A, 6]
    rows of (class_id, score, x1, y1, x2, y2), sorted by score; a
    suppressed row has class_id -1. A score must be above ``threshold``;
    class ids skip ``background_id``. The greedy pass is
    :func:`multibox_nms`."""
    cls_id, score, boxes = detection_rows(cls_prob, loc_pred, anchor, clip,
                                          threshold, background_id,
                                          variances)
    num_anchors = cls_id.shape[1]
    limit = num_anchors if nms_topk <= 0 else min(int(nms_topk), num_anchors)
    cls_id = multibox_nms(boxes, cls_id, nms_threshold, force_suppress, limit)
    return torch.cat([cls_id[..., None], score[..., None], boxes], -1)


# ---------------------------------------------------------------------------
# RPN Proposal
# ---------------------------------------------------------------------------

def _top_k(x, k):
    """(values, indices) of the ``k`` largest of each row, ties in index
    order, as ``lax.top_k`` gives them."""
    order = torch.argsort(-x, dim=-1, stable=True)[..., :k]
    return torch.gather(x, -1, order), order


@register("_contrib_Proposal", aliases=("Proposal", "proposal"),
          differentiable=False)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """Object proposals from RPN outputs: anchor enumeration, box decode,
    clip, min-size filter, top-k and NMS (:func:`multibox_nms` over one
    class). Returns [B*post, 5] rois of (batch_idx, x1, y1, x2, y2), a
    short result padded with the top box; and the scores [B*post, 1]
    under ``output_score``."""
    cls_prob = cls_prob.detach().to(torch.float32)
    bbox_pred = bbox_pred.detach().to(torch.float32)
    im_info = im_info.detach().to(torch.float32)
    b, twice_a, h, w = cls_prob.shape
    num_anchor = twice_a // 2
    dev = cls_prob.device
    base = float(feature_stride)
    ctr = (base - 1) / 2
    anchors = []
    for r in ratios:
        ws = torch.sqrt(torch.tensor(base * base / r, dtype=torch.float32))
        hs = ws * r
        for s in scales:
            anchors.append(torch.stack([ctr - (ws * s) / 2,
                                        ctr - (hs * s) / 2,
                                        ctr + (ws * s) / 2,
                                        ctr + (hs * s) / 2]))
    base_anchors = torch.stack(anchors[:num_anchor]).to(dev)
    sy = _grid(h, torch.float32, dev) * base
    sx = _grid(w, torch.float32, dev) * base
    shift = torch.stack(torch.meshgrid(sx, sy, indexing="xy"), -1)
    shifts = torch.cat([shift, shift], -1).reshape(-1, 4)
    all_anchors = (base_anchors[None] + shifts[:, None]).reshape(-1, 4)
    n_total = all_anchors.shape[0]

    scores = cls_prob[:, num_anchor:].permute(0, 2, 3, 1).reshape(b, -1)
    d = bbox_pred.reshape(b, num_anchor, 4, h, w).permute(
        0, 3, 4, 1, 2).reshape(b, -1, 4)
    aw = all_anchors[:, 2] - all_anchors[:, 0] + 1
    ah = all_anchors[:, 3] - all_anchors[:, 1] + 1
    acx = all_anchors[:, 0] + aw / 2
    acy = all_anchors[:, 1] + ah / 2
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    bw = torch.exp(torch.clamp(d[..., 2], -10, 10)) * aw
    bh = torch.exp(torch.clamp(d[..., 3], -10, 10)) * ah
    boxes = torch.stack([cx - bw / 2, cy - bh / 2,
                         cx + bw / 2, cy + bh / 2], -1)
    hi = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                      im_info[:, 1] - 1, im_info[:, 0] - 1], -1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi[:, None, :])
    min_size = rpn_min_size * im_info[:, 2:3]
    ok = ((boxes[..., 2] - boxes[..., 0] + 1) >= min_size) & \
         ((boxes[..., 3] - boxes[..., 1] + 1) >= min_size)
    scores2 = torch.where(ok, scores, -math.inf)
    pre = min(rpn_pre_nms_top_n, n_total)
    top_scores, top_idx = _top_k(scores2, pre)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(
        b, pre, 4)).contiguous()
    one_class = torch.zeros(b, pre, dtype=torch.float32, device=dev)
    alive = multibox_nms(top_boxes, one_class, threshold, True, pre) >= 0
    rank = torch.where(alive, top_scores, -math.inf)
    post = min(rpn_post_nms_top_n, pre)
    keep_scores, keep_idx = _top_k(rank, post)
    good = torch.isfinite(keep_scores)
    keep_idx = torch.where(good, keep_idx, keep_idx[:, :1])
    keep_scores = torch.where(good, keep_scores, keep_scores[:, :1])
    kept = torch.gather(top_boxes, 1, keep_idx[..., None].expand(b, post, 4))
    bidx = torch.repeat_interleave(_grid(b, torch.float32, dev), post)[:, None]
    flat = torch.cat([bidx, kept.reshape(-1, 4)], -1)
    if output_score:
        return flat, keep_scores.reshape(-1, 1)
    return flat


@register("_contrib_MultiProposal", aliases=("MultiProposal",),
          differentiable=False)
def multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Batched Proposal: :func:`proposal` is batched already."""
    return proposal(cls_prob, bbox_pred, im_info, **kwargs)


# ---------------------------------------------------------------------------
# Bilinear sampling / spatial transformer
# ---------------------------------------------------------------------------

def _bilinear_gather(img, gx, gy):
    """Sample img [N, C, H, W] at float pixel coordinates gx, gy
    [N, Ho, Wo], zeros outside (differentiable in img and the
    coordinates)."""
    n, c, h, w = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = img.reshape(n, c, h * w)

    def tap(xi, yi, wgt):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape((n, c) + tuple(gx.shape[1:]))
        return vals * (wgt * inb)[:, None]

    return (tap(x0, y0, wx0 * wy0) + tap(x1, y0, wx1 * wy0)
            + tap(x0, y1, wx0 * wy1) + tap(x1, y1, wx1 * wy1))


@register("BilinearSampler", aliases=("bilinear_sampler",))
def bilinear_sampler(data, grid):
    """data [N, C, H, W], grid [N, 2, Ho, Wo] with x, y in [-1, 1]."""
    _n, _c, h, w = data.shape
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_gather(data, gx, gy)


@register("GridGenerator", aliases=("grid_generator",))
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: data [N, 6] -> a sampling grid [N, 2, H, W]; warp: data is
    a flow field [N, 2, H, W] added to the identity grid."""
    dev = data.device
    if transform_type == "affine":
        h, w = target_shape
        theta = data.reshape(-1, 2, 3)
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", theta, coords.to(theta.dtype))
        return out.reshape(-1, 2, h, w)
    _n, _, h, w = data.shape
    gy, gx = torch.meshgrid(_grid(h, torch.float32, dev),
                            _grid(w, torch.float32, dev), indexing="ij")
    px = gx + data[:, 0]
    py = gy + data[:, 1]
    nx = px * 2 / max(w - 1, 1) - 1
    ny = py * 2 / max(h - 1, 1) - 1
    return torch.stack([nx, ny], 1)


@register("SpatialTransformer", aliases=("spatial_transformer",))
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear"):
    """Affine spatial transformer: loc [N, 6] -> the sampled output."""
    return bilinear_sampler(data, grid_generator(loc, "affine",
                                                 target_shape))


# ---------------------------------------------------------------------------
# Correlation (FlowNet's cost volume)
# ---------------------------------------------------------------------------

@register("Correlation", aliases=("correlation",))
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """Cost volume: for each displacement (dy, dx) within
    max_displacement, the mean over channels and the k x k patch of
    data1 * shifted(data2) (|data1 - shifted| without ``is_multiply``);
    displaced reads outside the map see zeros; the border cropped, then
    strided."""
    _n, _c, h, w = data1.shape
    d = int(max_displacement)
    k = int(kernel_size)
    pad = int(pad_size)
    border = d + k // 2
    hp, wp = h + 2 * pad, w + 2 * pad
    a = F.pad(data1, (pad,) * 4)
    b = F.pad(data2, (pad + d,) * 4)
    lo = (k - 1) // 2
    window = (lo, k - 1 - lo) * 2
    outs = []
    for dy in range(-d, d + 1, int(stride2)):
        for dx in range(-d, d + 1, int(stride2)):
            shifted = b[:, :, d + dy:d + dy + hp, d + dx:d + dx + wp]
            if is_multiply:
                prod = (a * shifted).mean(dim=1)
            else:
                prod = torch.abs(a - shifted).mean(dim=1)
            if k > 1:
                # the k x k window's sum ("SAME" padding) over k*k
                prod = F.avg_pool2d(F.pad(prod[:, None], window), k,
                                    stride=1)[:, 0]
            outs.append(prod)
    out = torch.stack(outs, 1)                      # [N, D*D, Hp, Wp]
    if border > 0:
        top = min(border, (hp - 1) // 2)
        left = min(border, (wp - 1) // 2)
        out = out[:, :, top:hp - top or None, left:wp - left or None]
    if stride1 > 1:
        out = out[:, :, ::stride1, ::stride1]
    return out


# ---------------------------------------------------------------------------
# Sequence ops
# ---------------------------------------------------------------------------

@register("SequenceLast", aliases=("sequence_last",))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """The last valid step of each sequence; data [T, B, ...] (axis 0)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.to(torch.int64) - 1
    moved = torch.movedim(data, axis, 0)                # [T, B, ...]
    return moved[idx, _grid(moved.shape[1], torch.int64, data.device)]


@register("SequenceMask", aliases=("sequence_mask",))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """``value`` at the steps beyond each sequence's length."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = _grid(data.shape[axis], torch.int64, data.device)
    mask = steps[:, None] < sequence_length.to(torch.int64)[None, :]
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceReverse", aliases=("sequence_reverse",))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Reverse along time within each sequence's length; data [T, B, ...]
    (or [B, T, ...] with axis 1)."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, dims=(axis,))
    moved = torch.movedim(data, axis, 0)                # [T, B, ...]
    steps = _grid(moved.shape[0], torch.int64, data.device)[:, None]
    lens = sequence_length.to(torch.int64)[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)   # [T, B]
    out = moved[src, _grid(moved.shape[1], torch.int64, data.device)[None]]
    return torch.movedim(out, 0, axis)
