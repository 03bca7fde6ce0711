"""The ``nd`` spatial and detection ops (counterpart of the spatial
transformer, ROI and MultiBox ops of ``mxnet_tpu/ndarray/ops.py``),
re-exported by :mod:`.ops`.

They keep the reference's formulas, which are neither torchvision's nor
MXNet C++'s in places:

- Bilinear sampling reads normalized coordinates ``g`` in [-1, 1] at
  pixel ``(g + 1)(size - 1) / 2`` with zeros outside:
  ``F.grid_sample(align_corners=True, padding_mode="zeros")``.
- ``ROIAlign`` samples ``sr x sr`` points a bin at ``y1 + (i + 0.5) *
  bin / sr`` in pixels, through that sampler; ``sample_ratio=-1`` reads
  as 2.
- ``ROIPooling`` rounds half away from zero, takes floor/ceil bin edges
  and gives 0 for an empty bin; its max is separable (rows, then
  columns) and so is its gradient, which splits evenly between tied
  maxima at each stage, as jax's does.
- ``box_nms`` is greedy in score order (a stable sort).  It finds the
  greedy answer as the fixed point of ``keep = cand & ~any_j<i(keep[j]
  & sup[j, i])`` over the candidates in score order, a few matrix-vector
  rounds instead of a step per row; row i is final after i rounds.
- ``MultiBoxTarget``: where two ground-truth rows force-match one
  anchor, the later row wins, as XLA's ordered scatter leaves it on the
  CPU.
"""
from __future__ import annotations

import builtins
import logging
import math

import torch
import torch.nn.functional as Fn

from .ops import _as_nd, _first_nd, invoke  # ops imports this at its end

__all__ = ["BilinearSampler", "GridGenerator", "SpatialTransformer",
           "ROIPooling", "ROIAlign", "box_iou", "box_nms", "MultiBoxPrior",
           "MultiBoxTarget", "MultiBoxDetection"]

# a bound on one temporary of the chunked ROI ops, in elements
_CHUNK_ELEMS = 1 << 26


# ------------------------------------------------------- spatial sampling

def _div(t, v):
    """``t / v`` for a number ``v``, rounded as a true division on every
    device: CUDA divides by a host scalar as a product with its
    reciprocal, which floors ``14 * (1/7)`` to 1 and moves a sample
    point by an ulp of its pixel coordinate."""
    return t / torch.tensor(float(v), dtype=t.dtype, device=t.device)


def _sample(x, grid):
    """(N, C, H, W) sampled at ``grid`` (N, Ho, Wo, 2) of normalized
    (x, y) coordinates, zeros outside."""
    return Fn.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)


def BilinearSampler(data, grid, **kw):
    """Sample (N, C, H, W) at ``grid`` (N, 2, Ho, Wo) of normalized
    coordinates, x then y (the STN sampling stage)."""
    like = _first_nd(data, grid)
    return invoke("BilinearSampler",
                  lambda x, g: _sample(x, g.permute(0, 2, 3, 1)),
                  [_as_nd(data, like), _as_nd(grid, like)])


def GridGenerator(data, transform_type="affine", target_shape=None, **kw):
    """A sampling grid (N, 2, H, W): from 6-dof affine parameters (N, 6)
    over ``target_shape``, or from a flow (N, 2, H, W) in pixels
    (``transform_type='warp'``)."""
    def f(t):
        if transform_type == "warp":
            _n, _two, h, w = t.shape
            ys, xs = torch.meshgrid(
                torch.arange(h, dtype=torch.float32, device=t.device),
                torch.arange(w, dtype=torch.float32, device=t.device),
                indexing="ij")
            gx = _div((xs[None] + t[:, 0]) * 2.0, w - 1) - 1.0
            gy = _div((ys[None] + t[:, 1]) * 2.0, h - 1) - 1.0
            return torch.stack([gx, gy], dim=1)
        h, w = target_shape
        gy, gx = torch.meshgrid(
            torch.linspace(-1.0, 1.0, h, device=t.device),
            torch.linspace(-1.0, 1.0, w, device=t.device), indexing="ij")
        src = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
        out = torch.einsum("nij,jk->nik", t.reshape(-1, 2, 3).to(src.dtype),
                           src)
        return out.reshape(-1, 2, h, w)
    return invoke("GridGenerator", f, [_as_nd(data)])


def SpatialTransformer(data, loc, target_shape=None, transform_type="affine",
                       sampler_type="bilinear", **kw):
    """STN: the affine grid of ``loc`` over ``target_shape``, then
    bilinear sampling of ``data`` at it."""
    grid = GridGenerator(loc, transform_type=transform_type,
                         target_shape=target_shape)
    return BilinearSampler(data, grid)


# ---------------------------------------------------------------- ROI ops

def _chunk(per_roi: int) -> int:
    return builtins.max(1, _CHUNK_ELEMS // builtins.max(per_roi, 1))


def _roi_bins(r, ph, pw, h, w, scale):
    """Per-ROI masks of each bin's rows (R, ph, H) and columns (R, pw, W)
    (the reference's rounding and floor/ceil edges) and batch ids."""
    q = torch.floor(r[:, 1:5] * scale + 0.5)           # half away from 0
    x1, y1, x2, y2 = q.unbind(1)
    rw = torch.clamp_min(x2 - x1 + 1.0, 1.0)
    rh = torch.clamp_min(y2 - y1 + 1.0, 1.0)

    def masks(start, extent, bins, size):
        i = torch.arange(bins, dtype=r.dtype, device=r.device)[None]
        lo = torch.floor(start[:, None] + _div(i * extent[:, None], bins))
        hi = torch.ceil(start[:, None] + _div((i + 1) * extent[:, None],
                                              bins))
        pix = torch.arange(size, dtype=r.dtype, device=r.device)
        return (pix >= lo[..., None]) & (pix < hi[..., None])
    return (r[:, 0].long(), masks(y1, rh, ph, h), masks(x1, rw, pw, w))


class _ROIPool(torch.autograd.Function):
    """ROI max pooling by rows then columns, in chunks of ROIs, saving
    the row maxima (R, C, ph, W) rather than any (R, C, H, W) mask."""

    @staticmethod
    def forward(ctx, x, r, ph, pw, scale):
        _n, c, h, w = x.shape
        b, my, mx = _roi_bins(r.float(), ph, pw, h, w, scale)
        neg = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
        step = _chunk(c * h * w)
        rowm, out = [], []
        for s in range(0, r.shape[0], step):
            fm = x.index_select(0, b[s:s + step])            # (r, C, H, W)
            rm = torch.stack([torch.where(
                my[s:s + step, i, None, :, None], fm, neg).amax(2)
                for i in range(ph)], 2)                      # (r, C, ph, W)
            out.append(torch.stack([torch.where(
                mx[s:s + step, j, None, None, :], rm, neg).amax(3)
                for j in range(pw)], 3))                     # (r, C, ph, pw)
            rowm.append(rm)
        out = torch.cat(out) if out else x.new_zeros((0, c, ph, pw))
        rowm = torch.cat(rowm) if rowm else x.new_zeros((0, c, ph, w))
        ctx.save_for_backward(x, b, my, mx, rowm, out)
        ctx.step = step
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

    @staticmethod
    def backward(ctx, g):
        x, b, my, mx, rowm, out = ctx.saved_tensors
        g = torch.where(torch.isfinite(out), g, torch.zeros_like(g))
        # column stage: each bin's gradient split over its tied columns
        g_row = torch.zeros_like(rowm)
        for j in range(g.shape[3]):
            tie = mx[:, j, None, None, :] & (rowm == out[..., j, None])
            cnt = tie.sum(3, keepdim=True).clamp_min(1)
            g_row += tie * (g[..., j, None] / cnt)
        # row stage: each row maximum's gradient over its tied rows
        gx = torch.zeros_like(x)
        for s in range(0, b.shape[0], ctx.step):
            fm = x.index_select(0, b[s:s + ctx.step])
            gfm = torch.zeros_like(fm)
            for i in range(rowm.shape[2]):
                tie = my[s:s + ctx.step, i, None, :, None] & (
                    fm == rowm[s:s + ctx.step, :, i, None, :])
                cnt = tie.sum(2, keepdim=True).clamp_min(1)
                gfm += tie * (g_row[s:s + ctx.step, :, i, None, :] / cnt)
            gx.index_add_(0, b[s:s + ctx.step], gfm)
        return gx, None, None, None, None


def ROIPooling(data, rois, pooled_size, spatial_scale, **kw):
    """Max-pool each ROI (R, 5) ``[batch, x1, y1, x2, y2]`` in image
    coordinates into a ``pooled_size`` grid: (R, C, ph, pw)."""
    like = _first_nd(data, rois)
    ph, pw = pooled_size
    return invoke("ROIPooling", lambda x, r: _ROIPool.apply(
        x, r, ph, pw, float(spatial_scale)),
        [_as_nd(data, like), _as_nd(rois, like)])


_WARNED_ADAPTIVE = []


def _roi_align(x, r, ph, pw, scale, sr, position_sensitive):
    n, c, h, w = x.shape
    x1, y1, x2, y2 = (r[:, 1:5] * scale).unbind(1)
    rw = torch.clamp_min(x2 - x1, 1.0)
    rh = torch.clamp_min(y2 - y1, 1.0)
    iy = torch.arange(ph * sr, dtype=r.dtype, device=r.device)
    ix = torch.arange(pw * sr, dtype=r.dtype, device=r.device)
    sy = y1[:, None] + _div((iy + 0.5) * _div(rh, ph)[:, None], sr)
    sx = x1[:, None] + _div((ix + 0.5) * _div(rw, pw)[:, None], sr)
    gy = _div(sy * 2.0, builtins.max(h - 1, 1)) - 1.0       # (R, ph*sr)
    gx = _div(sx * 2.0, builtins.max(w - 1, 1)) - 1.0       # (R, pw*sr)
    grid = torch.stack(torch.broadcast_tensors(
        gx[:, None, :], gy[:, :, None]), dim=-1).to(x.dtype)
    b = r[:, 0].long()
    parts, where_ = [], []
    step = _chunk(c * ph * sr * pw * sr)
    for img in range(n):
        rows = torch.nonzero(b == img).flatten()
        for s in range(0, rows.numel(), step):
            sel = rows[s:s + step]
            k = sel.numel()
            # one tall grid per image: the ROIs' sample grids stacked
            got = _sample(x[img:img + 1], grid[sel].reshape(
                1, k * ph * sr, pw * sr, 2))                # (1, C, k*., .)
            got = got.reshape(c, k, ph, sr, pw, sr).mean((3, 5))
            parts.append(got.permute(1, 0, 2, 3))
            where_.append(sel)
    if not parts:
        pooled = x.new_zeros((0, c, ph, pw))
    else:
        pooled = torch.cat(parts)[torch.argsort(torch.cat(where_))]
    if position_sensitive:
        # PS-ROIAlign (R-FCN): bin (i, j) pools its own channel group
        g = pooled.reshape(pooled.shape[0], c // (ph * pw), ph, pw, ph, pw)
        ii = torch.arange(ph, device=x.device)[:, None]
        jj = torch.arange(pw, device=x.device)[None, :]
        return g[:, :, ii, jj, ii, jj]
    return pooled


def ROIAlign(data, rois, pooled_size=None, spatial_scale=1.0,
             sample_ratio=2, position_sensitive=False, **kw):
    """ROI Align with bilinear sampling: (R, C, ph, pw), or with
    ``position_sensitive`` (R, C / (ph * pw), ph, pw).  The reference's
    ``sample_ratio=-1`` (upstream: adapt the samples to each ROI) reads
    as 2, with one warning."""
    like = _first_nd(data, rois)
    ph, pw = pooled_size
    if sample_ratio < 0:
        if not _WARNED_ADAPTIVE:
            logging.warning(
                "ROIAlign sample_ratio=-1 (adaptive) needs dynamic "
                "shapes; using a static 2x2 sample grid per bin")
            _WARNED_ADAPTIVE.append(True)
        sample_ratio = 2
    sr = builtins.max(int(sample_ratio), 1)
    return invoke("ROIAlign", lambda x, r: _roi_align(
        x, r, ph, pw, float(spatial_scale), sr, position_sensitive),
        [_as_nd(data, like), _as_nd(rois, like)])


# -------------------------------------------------------------- detection

def _corners(b, fmt):
    """Corner boxes (..., 4) of boxes in ``fmt`` ('corner' or 'center')."""
    if fmt == "center":
        cx, cy, w, h = b.unbind(-1)
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           dim=-1)
    return b


def _corner_to_center(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return (b[..., 0] + w / 2, b[..., 1] + h / 2, w, h)


def pairwise_iou(a, b):
    """IoU matrix of corner boxes a (..., N, 4) x b (..., M, 4)."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    iw = torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0)
    ih = torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0)
    inter = iw * ih
    area_a = torch.clamp_min(ax2 - ax1, 0) * torch.clamp_min(ay2 - ay1, 0)
    area_b = torch.clamp_min(bx2 - bx1, 0) * torch.clamp_min(by2 - by1, 0)
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-12)


def box_iou(lhs, rhs, format="corner", **kw):
    """Pairwise IoU of (..., N, 4) x (..., M, 4) boxes."""
    like = _first_nd(lhs, rhs)
    return invoke("box_iou", lambda a, b: pairwise_iou(
        _corners(a, format), _corners(b, format)),
        [_as_nd(lhs, like), _as_nd(rhs, like)])


def _nms_keep(rows, boxes, overlap_thresh, valid_thresh, topk,
              score_index, id_index, force_suppress):
    """Which rows (N,) of one image greedy NMS keeps, with ``boxes`` the
    rows' corner boxes.  Candidates are the valid rows of score rank <
    ``topk``: the first ``m`` of the stable score order (one host read
    for ``m``).  Rounds of one matrix-vector product each reach the
    greedy answer's fixed point."""
    n = rows.shape[0]
    scores = rows[:, score_index]
    valid = scores > valid_thresh
    order = torch.argsort(-torch.where(valid, scores, torch.full_like(
        scores, -math.inf)), stable=True)
    kmax = n if topk is None or topk < 0 else builtins.min(topk, n)
    m = builtins.min(kmax, int(valid.sum()))
    cand = order[:m]
    keep = torch.ones(m, dtype=torch.bool, device=rows.device)
    if m > 1:
        cb = boxes[cand]
        sup = pairwise_iou(cb, cb) > overlap_thresh
        if not (force_suppress or id_index < 0):
            ids = rows[cand, id_index]
            sup &= ids[:, None] == ids[None, :]
        sup = torch.triu(sup, diagonal=1).to(torch.float32)  # j before i
        while True:
            new = (keep.to(torch.float32) @ sup) == 0
            if torch.equal(new, keep):
                break
            keep = new
    kept = torch.zeros(n, dtype=torch.bool, device=rows.device)
    kept[cand[keep]] = True
    return kept


def _box_nms(x, overlap_thresh, valid_thresh, topk, coord_start,
             score_index, id_index, force_suppress, in_format, out_format):
    xb = x if x.dim() == 3 else x.reshape(1, -1, x.shape[-1])
    boxes = _corners(xb[..., coord_start:coord_start + 4], in_format)
    with torch.no_grad():
        kept = torch.stack([_nms_keep(
            xb[i], boxes[i], overlap_thresh, valid_thresh, topk,
            score_index, id_index, force_suppress)
            for i in range(xb.shape[0])])
    out_rows = xb
    if out_format != in_format:
        b4 = boxes
        if out_format == "center":
            b4 = torch.stack(_corner_to_center(boxes), dim=-1)
        out_rows = torch.cat([xb[..., :coord_start], b4,
                              xb[..., coord_start + 4:]], dim=-1)
    out = torch.where(kept[..., None], out_rows,
                      torch.full_like(out_rows, -1.0))
    return out.reshape(x.shape)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", **kw):
    """Greedy non-maximum suppression of (N, K) or (B, N, K) rows:
    suppressed, invalid and past-``topk`` rows become -1; the coordinate
    columns are rewritten only when ``out_format`` differs."""
    return invoke("box_nms", lambda x: _box_nms(
        x, overlap_thresh, valid_thresh, topk, coord_start, score_index,
        id_index, force_suppress, in_format, out_format), [_as_nd(data)])


def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kw):
    """Anchor boxes of each pixel of ``data``'s (H, W) map: (1, H*W*A, 4)
    corners in [0, 1], A = len(sizes) + len(ratios) - 1 (every size at
    ratios[0], then sizes[0] at the other ratios)."""
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    wh = [(s * math.sqrt(ratios[0]), s / math.sqrt(ratios[0]))
          for s in sizes]
    wh += [(sizes[0] * math.sqrt(r), sizes[0] / math.sqrt(r))
           for r in ratios[1:]]

    def f(x):
        h, w = x.shape[2], x.shape[3]
        step_y = steps[0] if steps[0] > 0 else 1.0 / h
        step_x = steps[1] if steps[1] > 0 else 1.0 / w
        cy = (torch.arange(h, dtype=torch.float32, device=x.device)
              + offsets[0]) * step_y
        cx = (torch.arange(w, dtype=torch.float32, device=x.device)
              + offsets[1]) * step_x
        cyy, cxx = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([cxx, cyy], dim=-1).reshape(-1, 1, 2)
        half = torch.tensor(wh, dtype=torch.float32,
                            device=x.device)[None] / 2.0
        out = torch.cat([centers - half, centers + half],
                        dim=-1).reshape(1, -1, 4)
        return torch.clamp(out, 0.0, 1.0) if clip else out
    return invoke("MultiBoxPrior", f, [_as_nd(data)])


def _multibox_target(anc, lab, cp, overlap_threshold, ignore_label,
                     negative_mining_ratio, negative_mining_thresh, v):
    a = anc.reshape(-1, 4).float()
    na = a.shape[0]
    bsz, m_gt = lab.shape[0], lab.shape[1]
    valid = lab[..., 0] >= 0                                   # (B, M)
    gt = lab[..., 1:5].float()                                 # (B, M, 4)
    iou = pairwise_iou(a[None], gt)                            # (B, A, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_gt = torch.argmax(iou, dim=2)                         # per anchor
    best_iou = torch.amax(iou, dim=2)
    # force-match: each valid ground truth claims its best anchor, the
    # later row winning a shared anchor; padding rows go to a spill slot
    best_anchor = torch.argmax(iou, dim=1)                     # (B, M)
    scatter_to = torch.where(valid, best_anchor,
                             torch.full_like(best_anchor, na))
    rows = torch.arange(m_gt, device=lab.device).expand(bsz, m_gt)
    forced_gt = torch.full((bsz, na + 1), -1, dtype=torch.long,
                           device=lab.device).scatter_reduce(
        1, scatter_to, rows, "amax")[:, :na]
    forced = forced_gt >= 0
    matched = forced | (best_iou >= overlap_threshold)
    gt_idx = torch.where(forced, forced_gt, best_gt)
    cls_t = torch.where(matched, torch.gather(lab[..., 0].float(), 1, gt_idx)
                        + 1.0, torch.zeros_like(best_iou))
    if negative_mining_ratio > 0:
        # hard negative mining: the ratio * n_pos negatives the network
        # scores highest as foreground stay background, the others are
        # ignored
        neg_cand = ~matched & (best_iou < negative_mining_thresh)
        hardness = torch.amax(cp[:, 1:, :].float(), dim=1)     # (B, A)
        hardness = torch.where(neg_cand, hardness,
                               torch.full_like(hardness, -math.inf))
        n_pos = matched.sum(1, keepdim=True)
        k = torch.minimum((negative_mining_ratio * n_pos).long(),
                          neg_cand.sum(1, keepdim=True))
        order = torch.argsort(-hardness, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(na, device=order.device).expand_as(order))
        mined = neg_cand & (rank < k)
        cls_t = torch.where(matched, cls_t, torch.where(
            mined, torch.zeros_like(cls_t),
            torch.full_like(cls_t, float(ignore_label))))
    acx, acy, aw, ah = _corner_to_center(a)
    mt = torch.gather(gt, 1, gt_idx[..., None].expand(bsz, na, 4))
    gcx, gcy, gw, gh = _corner_to_center(mt)
    aw_, ah_ = torch.clamp_min(aw, 1e-12), torch.clamp_min(ah, 1e-12)
    lt = torch.stack([(gcx - acx) / aw_ / v[0], (gcy - acy) / ah_ / v[1],
                      torch.log(torch.clamp_min(gw, 1e-12) / aw_) / v[2],
                      torch.log(torch.clamp_min(gh, 1e-12) / ah_) / v[3]],
                     dim=2)
    mask = matched.float()[..., None]
    return ((lt * mask).reshape(bsz, -1),
            mask.expand(bsz, na, 4).reshape(bsz, -1), cls_t)


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5,
                   variances=(0.1, 0.1, 0.2, 0.2), **kw):
    """SSD training targets: anchors (1, A, 4) matched to labels (B, M,
    5) ``[cls, x1, y1, x2, y2]`` (-1 rows pad) → (loc_target (B, A*4),
    loc_mask (B, A*4), cls_target (B, A)), class 0 the background."""
    like = _first_nd(anchor, label, cls_pred)
    v = tuple(float(x) for x in variances)
    return invoke("MultiBoxTarget", lambda a, lab, cp: _multibox_target(
        a, lab, cp, overlap_threshold, ignore_label, negative_mining_ratio,
        negative_mining_thresh, v),
        [_as_nd(anchor, like), _as_nd(label, like), _as_nd(cls_pred, like)],
        differentiable=False)


def _decode(cp, lp, anc, clip, threshold, v):
    a = anc.reshape(-1, 4)
    acx, acy, aw, ah = _corner_to_center(a)
    loc = lp.reshape(lp.shape[0], -1, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw
    h = torch.exp(loc[..., 3] * v[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=2)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    score = torch.amax(cp[:, 1:, :], dim=1)                    # (B, A)
    cls_id = torch.argmax(cp[:, 1:, :], dim=1)                 # the first
    keep = score > threshold
    neg = torch.full_like(score, -1.0)
    return torch.cat([torch.where(keep, cls_id.to(score.dtype),
                                  neg)[..., None],
                      torch.where(keep, score, neg)[..., None], boxes], dim=2)


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      nms_threshold=0.5, force_suppress=False,
                      variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1, **kw):
    """Decode SSD predictions (class probabilities (B, C+1, A), class 0
    the background; offsets (B, A*4)) and suppress duplicates: (B, A, 6)
    rows ``[cls_id, score, x1, y1, x2, y2]``, suppressed rows -1."""
    like = _first_nd(cls_prob, loc_pred, anchor)
    v = tuple(float(x) for x in variances)
    decoded = invoke("MultiBoxDetection_decode", lambda cp, lp, a: _decode(
        cp, lp, a, clip, threshold, v),
        [_as_nd(cls_prob, like), _as_nd(loc_pred, like),
         _as_nd(anchor, like)], differentiable=False)
    return box_nms(decoded, overlap_thresh=nms_threshold,
                   valid_thresh=threshold, topk=nms_topk, coord_start=2,
                   score_index=1, id_index=0, force_suppress=force_suppress)
