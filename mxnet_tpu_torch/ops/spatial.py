"""Spatial ops: ``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, ``ROIPooling`` and ``Correlation``.

Counterparts of ``mxnet_tpu/ops/spatial.py``, with the same names,
parameters and shape inference, in plain torch (the JAX package leaves
them to XLA).  Each op gives the JAX op's forward and the gradient that
``jax.vjp`` gives, and the gradients replay bit for bit on the card:

* the sampler's four corner reads are one row gather from a channels-last
  copy of the data (``indexing.gather_rows``), whose gradient is a sorted
  segment sum, not an indexed add with atomics;
* ``ROIPooling`` takes each bin's max over a window of the feature map (a
  gather of the bins' windows, in chunks of ROIs), not over masked copies
  of the whole map per bin.  A tied maximum passes ``g / count`` to each
  tied element, the rule of ``jnp.max`` over both axes; the scatter of the
  gradient is the same sorted segment sum;
* ``Correlation`` forms one displacement at a time from shifted views of
  the padded inputs and sums over channels before the next one, and its
  backward adds into the padded gradients in the same fixed order.

ROI corners are rounded half to even (``torch.round``, as ``jnp.round``);
the reference's C++ ``round`` rounds half away from zero.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .indexing import gather_rows
from .param import Param
from .registry import register


def _div(x, d):
    """``x / d`` by IEEE division on every device.  PyTorch's CUDA kernel
    turns a division by a host scalar into a product with its reciprocal,
    which rounds otherwise than the CPU's division; a divisor on ``x``'s
    device keeps the card's bits the CPU's (and JAX's op by op: XLA's
    compiled graphs multiply by the reciprocal too)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# GridGenerator / BilinearSampler / SpatialTransformer
# ---------------------------------------------------------------------------


def _linspace(n, device):
    """``jnp.linspace(-1.0, 1.0, n)`` in float32 with the JAX package's
    bits on the CPU: ``start * (1 - h) + stop * h`` with h = i / div, which
    XLA computes as h = i · (1 / div) rounded, and the last product fused
    into the add (one rounding of i · (1 / div) - (1 - h)); this holds up
    to n = 352, and past it XLA's code differs in the last bit.  A sampling
    grid whose points sit exactly on pixels (STN at the identity) takes its
    corners, and the gradient to the grid its side, from these bits."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    div = n - 1
    recip = _div(torch.ones((), dtype=torch.float32, device=device), div)
    i = torch.arange(div, dtype=torch.float32, device=device)
    one_minus_h = 1 - i * recip
    out = (i.double() * recip.double() - one_minus_h.double()).float()
    return torch.cat([out, torch.ones(1, device=device)])


def _affine_grid(theta, target_shape):
    """theta (N, 6) -> sampling grid (N, 2, H, W) in [-1, 1], x then y."""
    h, w = target_shape
    gy, gx = torch.meshgrid(_linspace(h, theta.device),
                            _linspace(w, theta.device), indexing="ij")
    coords = torch.stack([gx.reshape(-1), gy.reshape(-1),
                          torch.ones_like(gx).reshape(-1)])  # (3, H*W)
    dtype = torch.promote_types(theta.dtype, torch.float32)
    mat = theta.reshape(-1, 2, 3).to(dtype)
    out = torch.matmul(mat, coords.to(dtype))  # (N, 2, H*W)
    return out.reshape(theta.shape[0], 2, h, w)


def _grid_gen_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    if attrs.get("transform_type", "affine") == "affine":
        h, w = attrs["target_shape"]
        return in_shapes, [(d[0], 2, h, w)], []
    return in_shapes, [tuple(d)], []


@register("GridGenerator",
          params={"transform_type": Param(str, "affine",
                                          enum=("affine", "warp")),
                  "target_shape": Param("shape", (0, 0))},
          infer_shape=_grid_gen_infer, hint="gridgenerator")
def _grid_generator(opctx, attrs, data):
    if attrs.get("transform_type", "affine") == "affine":
        return _affine_grid(data, attrs["target_shape"])
    # warp: data is a flow field (N, 2, H, W) in pixels
    _, _, h, w = data.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=data.dtype, device=data.device),
        torch.arange(w, dtype=data.dtype, device=data.device), indexing="ij")
    x = _div(data[:, 0] + gx, max((w - 1) / 2.0, 1e-12)) - 1.0
    y = _div(data[:, 1] + gy, max((h - 1) / 2.0, 1e-12)) - 1.0
    return torch.stack([x, y], dim=1)


def _bilinear_sample(data, grid):
    """Sample data (N, C, H, W) at grid (N, 2, Ho, Wo) in [-1, 1], zero
    outside the image.  ``floor`` carries no gradient; the corner weights
    carry it to the grid."""
    n, c, h, w = data.shape
    ho, wo = grid.shape[2], grid.shape[3]
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0  # (N, Ho, Wo)
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    # the corners (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
    ys = torch.stack([y0, y0, y0 + 1, y0 + 1])
    xs = torch.stack([x0, x0 + 1, x0, x0 + 1])
    valid = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    yc = ys.clamp(0, h - 1).to(torch.int64)
    xc = xs.clamp(0, w - 1).to(torch.int64)
    batch = torch.arange(n, device=data.device).view(1, n, 1, 1)
    ids = ((batch * h + yc) * w + xc).reshape(-1)
    table = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
    vals = gather_rows(table, ids).reshape(4, n, ho, wo, c)
    vals = vals.permute(0, 1, 4, 2, 3) * valid[:, :, None].to(data.dtype)
    v00, v01, v10, v11 = vals.unbind(0)
    wx_ = wx[:, None]
    wy_ = wy[:, None]
    return (v00 * (1 - wx_) * (1 - wy_) + v01 * wx_ * (1 - wy_)
            + v10 * (1 - wx_) * wy_ + v11 * wx_ * wy_)


def _bilinear_infer(attrs, in_shapes):
    d, g = in_shapes
    if d is None or g is None:
        return in_shapes, [None], []
    return in_shapes, [(d[0], d[1], g[2], g[3])], []


@register("BilinearSampler", inputs=("data", "grid"),
          infer_shape=_bilinear_infer, hint="bilinearsampler")
def _bilinear_sampler(opctx, attrs, data, grid):
    return _bilinear_sample(data, grid)


def _st_infer(attrs, in_shapes):
    d = in_shapes[0]
    if d is None:
        return in_shapes, [None], []
    th, tw = attrs.get("target_shape", (0, 0))
    h = th or d[2]
    w = tw or d[3]
    return [d, (d[0], 6)], [(d[0], d[1], h, w)], []


@register("SpatialTransformer", inputs=("data", "loc"),
          params={"target_shape": Param("shape", (0, 0)),
                  "transform_type": Param(str, "affine", enum=("affine",)),
                  "sampler_type": Param(str, "bilinear",
                                        enum=("bilinear",))},
          infer_shape=_st_infer, hint="spatialtransformer")
def _spatial_transformer(opctx, attrs, data, loc):
    th, tw = attrs.get("target_shape", (0, 0))
    h = th or data.shape[2]
    w = tw or data.shape[3]
    return _bilinear_sample(data, _affine_grid(loc, (h, w)))


# ---------------------------------------------------------------------------
# ROIPooling
# ---------------------------------------------------------------------------

#: elements of one chunk of gathered bin windows (ROIPooling)
ROI_CHUNK_ELEMENTS = 1 << 26


def _bin_edges(lo, size, bins, limit):
    """Per ROI and bin, the first index and the count of the window along
    one axis: [floor(lo + p * bin), ceil(lo + (p + 1) * bin)) clipped to
    [0, limit)."""
    step = _div(size, bins)
    p = torch.arange(bins, dtype=lo.dtype, device=lo.device)
    start = torch.floor(lo[:, None] + p * step[:, None])
    end = torch.ceil(lo[:, None] + (p + 1) * step[:, None])
    start = start.clamp(0, limit)
    count = (end.clamp(0, limit) - start).clamp(min=0)
    return start.to(torch.int64), count.to(torch.int64)


def _roi_windows(data, rois, pooled_size, scale):
    """The flat row ids (R, PH, PW, KH, KW) of every bin's window in the
    channels-last table of ``data``, and which of them lie in the window
    (KH, KW: the largest window's extent)."""
    ph, pw = pooled_size
    _, _, h, w = data.shape
    batch = rois[:, 0].to(torch.int64)
    x0 = torch.round(rois[:, 1] * scale)
    y0 = torch.round(rois[:, 2] * scale)
    x1 = torch.round(rois[:, 3] * scale)
    y1 = torch.round(rois[:, 4] * scale)
    roi_h = torch.clamp(y1 - y0 + 1.0, min=1.0)
    roi_w = torch.clamp(x1 - x0 + 1.0, min=1.0)
    ys, ny = _bin_edges(y0, roi_h, ph, h)
    xs, nx = _bin_edges(x0, roi_w, pw, w)
    kh = max(int(ny.max()), 1) if ny.numel() else 1
    kw = max(int(nx.max()), 1) if nx.numel() else 1
    ky = torch.arange(kh, device=data.device)
    kx = torch.arange(kw, device=data.device)
    yy = ys[:, :, None] + ky  # (R, PH, KH)
    xx = xs[:, :, None] + kx  # (R, PW, KW)
    vy = ky < ny[:, :, None]
    vx = kx < nx[:, :, None]
    yy = yy.clamp(max=h - 1)
    xx = xx.clamp(max=w - 1)
    ids = ((batch[:, None, None, None, None] * h
            + yy[:, :, None, :, None]) * w + xx[:, None, :, None, :])
    valid = vy[:, :, None, :, None] & vx[:, None, :, None, :]
    return ids, valid


def _roi_chunks(ids, channels):
    per_roi = max(1, ids[0].numel() * channels) if len(ids) else 1
    step = max(1, ROI_CHUNK_ELEMENTS // per_roi)
    return [slice(i, i + step) for i in range(0, len(ids), step)]


def _window_values(table, ids, valid):
    """(r, PH, PW, KH, KW, C) window values, -inf outside the window."""
    win = table[ids.reshape(-1)].reshape(ids.shape + (table.shape[1],))
    neg = torch.tensor(-math.inf, dtype=table.dtype, device=table.device)
    return torch.where(valid[..., None], win, neg)


class _ROIMax(torch.autograd.Function):
    """Each bin's max over its window, 0 for an empty bin; the gradient
    ``g / count`` to each element equal to its bin's max, summed in a fixed
    order (a sorted segment sum per chunk of ROIs, chunks in order)."""

    @staticmethod
    def forward(ctx, data, rois, pooled_size, scale):
        n, c, h, w = data.shape
        r = rois.shape[0]
        ph, pw = pooled_size
        if data.device.type == "meta":
            return data.new_empty((r, c, ph, pw))
        ids, valid = _roi_windows(data, rois, pooled_size, scale)
        table = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
        out = data.new_empty((r, ph, pw, c))
        for sl in _roi_chunks(ids, c):
            m = _window_values(table, ids[sl], valid[sl]).amax(dim=(3, 4))
            out[sl] = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        ctx.save_for_backward(data, ids, valid, out)
        return out.permute(0, 3, 1, 2).contiguous()

    @staticmethod
    def backward(ctx, grad):
        data, ids, valid, out = ctx.saved_tensors
        n, c, h, w = data.shape
        table = data.permute(0, 2, 3, 1).reshape(n * h * w, c)
        g = grad.permute(0, 2, 3, 1)  # (R, PH, PW, C)
        gtable = torch.zeros((n * h * w, c), dtype=torch.float32,
                             device=data.device)
        for sl in _roi_chunks(ids, c):
            win = _window_values(table, ids[sl], valid[sl])
            hit = win == out[sl][:, :, :, None, None, :]
            count = hit.sum(dim=(3, 4), keepdim=True)
            share = g[sl][:, :, :, None, None, :] / count.clamp(min=1)
            contrib = torch.where(hit, share, torch.zeros_like(share))
            flat = ids[sl].reshape(-1)
            order = torch.argsort(flat, stable=True)
            uniq, counts = torch.unique_consecutive(flat[order],
                                                    return_counts=True)
            sums = torch.segment_reduce(
                contrib.reshape(-1, c)[order].to(torch.float32), "sum",
                lengths=counts, axis=0)
            gtable[uniq] = gtable[uniq] + sums  # unique rows: no atomics
        gdata = gtable.to(data.dtype).reshape(n, h, w, c).permute(0, 3, 1, 2)
        return gdata.contiguous(), None, None, None


def _roi_infer(attrs, in_shapes):
    d, r = in_shapes
    if d is None or r is None:
        return in_shapes, [None], []
    ph, pw = attrs["pooled_size"]
    return in_shapes, [(r[0], d[1], ph, pw)], []


@register("ROIPooling", inputs=("data", "rois"),
          params={"pooled_size": Param("shape", required=True),
                  "spatial_scale": Param(float, required=True)},
          infer_shape=_roi_infer, no_grad_inputs=("rois",),
          hint="roipooling")
def _roi_pooling(opctx, attrs, data, rois):
    """Max-pool each ROI (batch index, x0, y0, x1, y1 in image pixels) into
    a (PH, PW) grid: (R, C, PH, PW)."""
    return _ROIMax.apply(data, rois.detach(), tuple(attrs["pooled_size"]),
                         attrs["spatial_scale"])


# ---------------------------------------------------------------------------
# Correlation (FlowNet)
# ---------------------------------------------------------------------------


def _corr_geometry(attrs, shape):
    pad = attrs.get("pad_size", 0)
    k = attrs.get("kernel_size", 1)
    md = attrs.get("max_displacement", 1)
    s1 = attrs.get("stride1", 1)
    s2 = attrs.get("stride2", 1)
    ph, pw = shape[2] + 2 * pad, shape[3] + 2 * pad
    bd = md // s2
    kr = k // 2
    border = md + kr
    oh = int(math.ceil((ph - border * 2) / s1))
    ow = int(math.ceil((pw - border * 2) / s1))
    return pad, k, s1, s2, bd, kr, border, oh, ow


def _corr_infer(attrs, in_shapes):
    d1 = in_shapes[0]
    if d1 is None:
        return in_shapes, [None], []
    _, _, _, _, bd, _, _, oh, ow = _corr_geometry(attrs, d1)
    return in_shapes, [(d1[0], (2 * bd + 1) ** 2, oh, ow)], []


class _Correlation(torch.autograd.Function):
    """out[:, d] = sum over taps and channels of a * b (or |a - b|) / (k²C),
    a and b strided views of the padded inputs; one displacement at a time,
    so no stack of shifted copies is ever made."""

    @staticmethod
    def _pairs(geom):
        _, _, s1, s2, bd, kr, border, oh, ow = geom

        def rows(off, n):
            return slice(border + off, border + off + (n - 1) * s1 + 1, s1)

        taps = [(ky, kx) for ky in range(-kr, kr + 1)
                for kx in range(-kr, kr + 1)]
        for dy in range(-bd, bd + 1):
            for dx in range(-bd, bd + 1):
                yield [((slice(None), slice(None), rows(ky, oh), rows(kx, ow)),
                        (slice(None), slice(None), rows(ky + dy * s2, oh),
                         rows(kx + dx * s2, ow))) for ky, kx in taps]

    @staticmethod
    def forward(ctx, data1, data2, attrs):
        geom = _corr_geometry(attrs, data1.shape)
        pad, k, bd, oh, ow = geom[0], geom[1], geom[4], geom[7], geom[8]
        mult = attrs.get("is_multiply", True)
        p1 = F.pad(data1, (pad, pad, pad, pad))
        p2 = F.pad(data2, (pad, pad, pad, pad))
        ksz = float(k * k * data1.shape[1])
        out = data1.new_empty((data1.shape[0], (2 * bd + 1) ** 2, oh, ow))
        if data1.device.type != "meta":
            for i, taps in enumerate(_Correlation._pairs(geom)):
                acc = 0.0
                for ia, ib in taps:
                    a, b = p1[ia], p2[ib]
                    acc = acc + ((a * b).sum(1) if mult
                                 else (a - b).abs().sum(1))
                out[:, i] = _div(acc, ksz)
        ctx.save_for_backward(p1, p2)
        ctx.geom, ctx.mult, ctx.ksz = geom, mult, ksz
        return out

    @staticmethod
    def backward(ctx, grad):
        p1, p2 = ctx.saved_tensors
        pad = ctx.geom[0]
        g1 = torch.zeros_like(p1)
        g2 = torch.zeros_like(p2)
        for i, taps in enumerate(_Correlation._pairs(ctx.geom)):
            gi = _div(grad[:, i], ctx.ksz)[:, None]
            for ia, ib in taps:
                a, b = p1[ia], p2[ib]
                if ctx.mult:
                    g1[ia] += gi * b
                    g2[ib] += gi * a
                else:
                    s = gi * torch.sign(a - b)
                    g1[ia] += s
                    g2[ib] -= s
        h, w = p1.shape[2] - 2 * pad, p1.shape[3] - 2 * pad
        crop = (slice(None), slice(None), slice(pad, pad + h),
                slice(pad, pad + w))
        return g1[crop], g2[crop], None


@register("Correlation", inputs=("data1", "data2"),
          params={"kernel_size": Param(int, 1),
                  "max_displacement": Param(int, 1),
                  "stride1": Param(int, 1), "stride2": Param(int, 1),
                  "pad_size": Param(int, 0),
                  "is_multiply": Param(bool, True)},
          infer_shape=_corr_infer, hint="correlation")
def _correlation(opctx, attrs, data1, data2):
    return _Correlation.apply(data1, data2, dict(attrs))
