"""The rest of the reference registry's ops in the PyTorch port.

Counterpart of ``mxtpu/ops/extra_ops.py``: the bounding-box utilities
(MXNet's ``src/operator/contrib/bounding_box.cc``: ``box_iou``,
``box_nms``, ``bipartite_matching``), deformable convolution and
deformable position-sensitive ROI pooling (R-FCN,
``contrib/deformable_convolution.cc``,
``deformable_psroi_pooling.cc``), the legacy ``Crop`` op (which fully
convolutional nets use to align an upsampled map with another),
``reshape_like``, ``softmax_cross_entropy``, the docs' ``quadratic``
example op, ``adagrad_update``, ``IdentityAttachKLSparseReg``, the image
tensor ops (``image/image_random-inl.h``), and the aliases ``mxtpu``
gives here to ops ported elsewhere (``Convolution_v1``, ``Pooling_v1``,
``CuDNNBatchNorm``, ``_contrib_SparseEmbedding``).

``box_nms`` on the card runs the hand-written ``multibox_nms`` kernel of
``csrc/vision.cu`` (one block an image) after sorting the rows by valid
score: its ids, arbitrary floats, become class indices (-1 for a row
that is not valid), so the kernel's class rule is ``box_nms``'s. On the
CPU the kernel's plain loop runs. The deformable ops are gathers and a
matrix product, as in ``mxtpu``; ``bipartite_matching`` is a loop of
``min(topk, N)`` batched steps.
"""
from __future__ import annotations

import torch

from .registry import alias, register
from .vision import _bilinear_gather, _corner_iou, multibox_nms


# ---------------------------------------------------------------------------
# bounding boxes (contrib/bounding_box.cc)
# ---------------------------------------------------------------------------

def _to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    ctr, wh = boxes[..., :2], boxes[..., 2:4]
    return torch.cat([ctr - wh / 2, ctr + wh / 2], dim=-1)


@register("_contrib_box_iou", aliases=("box_iou",), differentiable=False)
def box_iou(lhs, rhs, format="corner"):
    """Pairwise IoU: lhs [..., N, 4] x rhs [..., M, 4] -> [..., N, M]."""
    a = _to_corner(lhs, format)[..., :, None, :]
    b = _to_corner(rhs, format)[..., None, :, :]
    return _corner_iou(a, b)


@register("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner"):
    """Non-maximum suppression over rows [..., N, K] that hold a score
    and 4 coordinates (and a class id at ``id_index``): the rows sorted
    by score, invalid ones (score not above ``valid_thresh``, or past
    ``topk``) last; a row that a higher one of its class (any, with
    ``force_suppress``) overlaps by more than ``overlap_thresh``, and
    every invalid row, gets score -1."""
    lead = tuple(data.shape[:-2])
    n, k = data.shape[-2], data.shape[-1]
    rows = data.reshape(-1, n, k)
    scores = rows[..., score_index]
    valid = scores > valid_thresh
    order = torch.argsort(-torch.where(valid, scores, float("-inf")),
                          dim=-1, stable=True)
    rows_s = torch.gather(rows, 1, order[..., None].expand(-1, -1, k))
    valid_s = torch.gather(valid, 1, order)
    limit = n if topk <= 0 else min(int(topk), n)
    boxes = _to_corner(rows_s[..., coord_start:coord_start + 4],
                       in_format).to(torch.float32).contiguous()
    if id_index >= 0:
        _, cls = torch.unique(rows_s[..., id_index], return_inverse=True)
        cls = cls.to(torch.float32)
    else:
        cls = torch.zeros_like(boxes[..., 0])
    cls = torch.where(valid_s, cls, -1.0).contiguous()
    kept = multibox_nms(boxes, cls, overlap_thresh, force_suppress, limit)
    out = rows_s.clone()
    out[..., score_index] = torch.where(kept >= 0, rows_s[..., score_index],
                                        -1.0)
    if out_format != in_format:
        cur = out[..., coord_start:coord_start + 4]
        if out_format == "corner":
            conv = _to_corner(cur, in_format)
        else:
            tl, br = cur[..., :2], cur[..., 2:4]
            conv = torch.cat([(tl + br) / 2, br - tl], dim=-1)
        out[..., coord_start:coord_start + 4] = conv
    return out.reshape(lead + (n, k))


@register("_contrib_bipartite_matching", num_outputs=2,
          differentiable=False)
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching of a score matrix [..., N, M]: take the
    best unmatched (row, column) pair while it passes ``threshold``.
    Returns (row_match [..., N], col_match [..., M]), -1 unmatched."""
    lead = tuple(data.shape[:-2])
    n, m = data.shape[-2], data.shape[-1]
    score = data.reshape(-1, n, m).to(torch.float32)
    b = score.shape[0]
    s = score * (1.0 if is_ascend else -1.0)
    row_m = torch.full((b, n), -1.0, device=data.device)
    col_m = torch.full((b, m), -1.0, device=data.device)
    items = torch.arange(b, device=data.device)
    for _ in range(n if topk <= 0 else min(int(topk), n)):
        idx = torch.argmin(s.reshape(b, -1), dim=1)
        r, c = idx // m, idx % m
        best = score[items, r, c]
        ok = torch.isfinite(s[items, r, c]) & (
            best <= threshold if is_ascend else best >= threshold)
        row_m[items, r] = torch.where(ok, c.to(row_m.dtype), row_m[items, r])
        col_m[items, c] = torch.where(ok, r.to(col_m.dtype), col_m[items, c])
        dead = ok[:, None, None] & (
            (torch.arange(n, device=data.device)[None, :, None]
             == r[:, None, None])
            | (torch.arange(m, device=data.device)[None, None, :]
               == c[:, None, None]))
        s = torch.where(dead, float("inf"), s)
    return row_m.reshape(lead + (n,)), col_m.reshape(lead + (m,))


# ---------------------------------------------------------------------------
# deformable ops (contrib/deformable_convolution.cc,
# deformable_psroi_pooling.cc)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), pad=(0, 0), dilate=(1, 1),
                           num_filter=0, num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1 (Dai et al., 2017): each tap of the
    kernel samples the input bilinearly (zeros outside) at its regular
    place plus a learned offset of its output position. data [B, C, H,
    W]; offset [B, 2 * G * kh * kw, Ho, Wo], (y, x) interleaved a tap,
    for G deformable groups of channels; weight [F, C / num_group, kh,
    kw]."""
    B, C, H, W = data.shape
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    dh, dw = dilate
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    G = num_deformable_group
    taps = kh * kw
    off = offset.reshape(B, G, taps, 2, Ho, Wo)
    dev, dt = data.device, data.dtype
    base_y = (torch.arange(Ho, device=dev, dtype=dt) * sh - ph)[:, None]
    base_x = (torch.arange(Wo, device=dev, dtype=dt) * sw - pw)[None, :]
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev, dtype=dt) * dh,
                            torch.arange(kw, device=dev, dtype=dt) * dw,
                            indexing="ij")
    ky = ky.reshape(taps, 1, 1)
    kx = kx.reshape(taps, 1, 1)
    Cg = C // G
    cols = []
    for g in range(G):
        y = base_y + ky + off[:, g, :, 0]            # [B, taps, Ho, Wo]
        x = base_x + kx + off[:, g, :, 1]
        cols.append(_bilinear_gather(data[:, g * Cg:(g + 1) * Cg], x, y))
    col = torch.cat(cols, dim=1)                     # [B, C, taps, Ho, Wo]
    F = weight.shape[0]
    wg = weight.reshape(num_group, F // num_group, C // num_group, taps)
    colg = col.reshape(B, num_group, (C // num_group) * taps, Ho * Wo)
    out = torch.matmul(wg.reshape(num_group, F // num_group, -1)[None],
                       colg)                          # [B, g, F/g, Ho*Wo]
    out = out.reshape(B, F, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, F, 1, 1)
    return out


def _sample(flat, index_base, gx, gy, h, w):
    """Bilinear samples (zeros outside, as :func:`_bilinear_gather`) of
    the flattened maps ``flat`` at (gx, gy); ``index_base`` is each
    sample's map offset in ``flat`` (broadcasting against gx)."""
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = gx - x0, gy - y0
    out = 0.0
    for xi, yi, wgt in ((x0, y0, (1 - wx1) * (1 - wy1)),
                        (x0 + 1, y0, wx1 * (1 - wy1)),
                        (x0, y0 + 1, (1 - wx1) * wy1),
                        (x0 + 1, y0 + 1, wx1 * wy1)):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        out = out + flat[index_base + yc * w + xc] * (wgt * inb)
    return out


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), num_outputs=1)
def deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                             output_dim=0, group_size=1, pooled_size=7,
                             part_size=0, sample_per_part=4,
                             trans_std=0.0, no_trans=False):
    """Deformable position-sensitive ROI pooling (R-FCN). data [B, C, H,
    W] with C = output_dim * group_size^2 (channel (o * gs + gy) * gs +
    gx for output o at group cell (gy, gx)); rois [R, 5] (batch index,
    x1, y1, x2, y2); trans [R, 2 * part^2] per-part offsets, scaled by
    ``trans_std`` and the ROI's size. Each bin averages a
    sample_per_part^2 grid of bilinear samples. Returns [R, output_dim,
    P, P]."""
    B, C, H, W = data.shape
    P, gs, S = int(pooled_size), int(group_size), int(sample_per_part)
    part = int(part_size) or P
    R = rois.shape[0]
    dev, dt = data.device, data.dtype
    b = rois[:, 0].to(torch.int64)
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = rw / P, rh / P
    iy, ix = torch.meshgrid(torch.arange(P, device=dev),
                            torch.arange(P, device=dev), indexing="ij")
    if no_trans or trans is None:
        off_y = torch.zeros((R, P, P), device=dev, dtype=dt)
        off_x = off_y
    else:
        tr = trans.reshape(R, 2, part, part)
        py, px = iy * part // P, ix * part // P
        off_y = tr[:, 0, py, px] * trans_std * rh[:, None, None]
        off_x = tr[:, 1, py, px] * trans_std * rw[:, None, None]
    sub = (torch.arange(S, device=dev, dtype=dt) + 0.5) / S

    def expand(v):                                   # [R] -> [R,1,1,1,1]
        return v.reshape(R, 1, 1, 1, 1)
    gy = expand(y1) + (iy[None, :, :, None, None] + sub[:, None]) \
        * expand(bin_h) + off_y[..., None, None]     # [R, P, P, S, 1]
    gx = expand(x1) + (ix[None, :, :, None, None] + sub) \
        * expand(bin_w) + off_x[..., None, None]     # [R, P, P, 1, S]
    chan = (iy * gs // P) * gs + (ix * gs // P)      # [P, P]
    c = torch.arange(output_dim, device=dev)[:, None, None] * (gs * gs) \
        + chan                                      # [O, P, P]
    base = ((b[:, None, None, None] * C + c[None]) * (H * W))[..., None,
                                                              None]
    vals = _sample(data.reshape(-1), base, gx[:, None], gy[:, None], H, W)
    return vals.mean(dim=(-1, -2))


# ---------------------------------------------------------------------------
# small ops
# ---------------------------------------------------------------------------

@register("reshape_like")
def reshape_like(lhs, rhs):
    """``lhs`` reshaped to ``rhs``'s shape."""
    return lhs.reshape(rhs.shape)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The summed cross-entropy of the softmax of ``data``'s last axis at
    the integer labels ``label``."""
    logp = torch.log_softmax(data, dim=-1)
    picked = torch.gather(logp, -1, label.to(torch.int64)[..., None])
    return -picked.sum()


@register("_contrib_quadratic", aliases=("quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    """a x^2 + b x + c (the reference docs' example op)."""
    return a * data * data + b * data + c


@register("adagrad_update", num_outputs=2)
def adagrad_update(weight, grad, history, lr=None, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad: (new weight, new history). ``lr`` is a required keyword
    param."""
    if lr is None:
        raise ValueError("adagrad_update requires lr")
    g = grad * rescale_grad
    if clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    g = g + wd * weight
    new_hist = history + g * g
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


alias("adagrad_update", "_sparse_adagrad_update")


class _KLSparseReg(torch.autograd.Function):
    """The identity, whose backward adds the gradient of a KL sparseness
    penalty on the mean sigmoid activation."""

    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.save_for_backward(x)
        ctx.rho, ctx.penalty = rho, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        rho, rho_hat = ctx.rho, torch.mean(s)
        dkl = (-rho / rho_hat + (1 - rho) / (1 - rho_hat)) / x.numel()
        return g + ctx.penalty * dkl * s * (1 - s), None, None


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """The identity; its backward adds penalty * d KL(rho || rho_hat) /
    d x, rho_hat the batch's mean sigmoid activation. ``momentum`` is
    taken and not applied, as in ``mxtpu`` (MXNet smooths rho_hat across
    batches in an aux state)."""
    return _KLSparseReg.apply(data, float(sparseness_target),
                              float(penalty))


@register("_image_to_tensor", aliases=("image_to_tensor",))
def image_to_tensor(data):
    """HWC (or NHWC) [0, 255] -> CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if data.dim() == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize", aliases=("image_normalize",))
def image_normalize(data, mean=(0.0,), std=(1.0,)):
    """(x - mean) / std over the channel axis of CHW (or NCHW) input."""
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    m = torch.tensor(mean, dtype=torch.float32, device=data.device)
    sd = torch.tensor(std, dtype=torch.float32, device=data.device)
    return (data - m.reshape(shape)) / sd.reshape(shape)


@register("Crop", aliases=("crop_like",))
def crop_op(data, crop_like=None, offset=(0, 0), h_w=(0, 0),
            center_crop=False, num_args=1):
    """``data``'s two spatial axes cut to ``crop_like``'s size (else to
    ``h_w``), from ``offset`` (y, x), or centred with ``center_crop``."""
    th, tw = (crop_like.shape[2], crop_like.shape[3]) \
        if crop_like is not None else tuple(h_w)
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = offset
    if not (0 <= oy and oy + th <= H and 0 <= ox and ox + tw <= W):
        raise ValueError("Crop: a %dx%d window at (%d, %d) does not fit a "
                         "%dx%d map" % (th, tw, oy, ox, H, W))
    return data[:, :, oy:oy + th, ox:ox + tw]


alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("BatchNorm", "CuDNNBatchNorm")
alias("Embedding", "_contrib_SparseEmbedding")
