"""ROI-Align (aligned=True) as separable contractions (port of
``hoigen_tpu/ops/roi_align.py``).

Bilinear sampling is linear in the feature map, so per-ROI interpolation
weight matrices W_y (N, ph, H) and W_x (N, pw, W) replace the gathers:
``out[n, c, p, q] = sum_{h, w} W_y[n, p, h] F[c, h, w] W_x[n, q, w]``. The
adaptive sampling ratio (torchvision's ceil(roi / out)) is bounded by a
static ``max_samples``.
"""
import torch


def _axis_weights(start, roi_len, pooled, grid, length, max_samples):
    """start/roi_len/grid (..., N) -> (..., N, pooled, length) weights
    including the 1/grid averaging."""
    dt = start.dtype
    dev = start.device
    bin_size = roi_len / pooled
    pb = torch.arange(pooled, dtype=dt, device=dev)
    iy = torch.arange(max_samples, dtype=dt, device=dev)
    pos = (start[..., None, None] + pb[:, None] * bin_size[..., None, None]
           + (iy + 0.5) * (bin_size / grid)[..., None, None])   # (..., N, P, S)
    in_range = (pos >= -1.0) & (pos <= length)
    sample_valid = (iy < grid[..., None, None]) & in_range
    pos = torch.clamp(pos, 0.0, length - 1.0)
    grid_pts = torch.arange(length, dtype=dt, device=dev)
    hat = torch.clamp(1.0 - (pos[..., None] - grid_pts).abs(), 0.0, 1.0)
    hat = hat * sample_valid[..., None]
    return hat.sum(-2) / grid[..., None, None]                  # (..., N, P, L)


def _grids(roi_len, pooled, sampling_ratio, max_samples):
    if sampling_ratio > 0:
        return torch.full_like(roi_len, float(sampling_ratio))
    return torch.clamp(torch.ceil(roi_len / pooled), 1.0, float(max_samples))


def _weights(features, rois, output_size, spatial_scale, sampling_ratio,
             max_samples):
    ph, pw = output_size
    height, width = features.shape[-2], features.shape[-1]
    rois = rois.to(features.dtype)
    x1 = rois[..., 0] * spatial_scale - 0.5
    y1 = rois[..., 1] * spatial_scale - 0.5
    x2 = rois[..., 2] * spatial_scale - 0.5
    y2 = rois[..., 3] * spatial_scale - 0.5
    roi_w, roi_h = x2 - x1, y2 - y1
    gy = _grids(roi_h, ph, sampling_ratio, max_samples)
    gx = _grids(roi_w, pw, sampling_ratio, max_samples)
    w_y = _axis_weights(y1, roi_h, ph, gy, height, max_samples)
    w_x = _axis_weights(x1, roi_w, pw, gx, width, max_samples)
    return w_y, w_x


def roi_align(features, rois, output_size, spatial_scale: float,
              sampling_ratio: int = -1, max_samples: int = 2):
    """features (B, C, H, W), rois (B, N, 4) xyxy in image coords ->
    (B, N, C, ph, pw). aligned=True semantics."""
    w_y, w_x = _weights(features, rois, tuple(output_size),
                        float(spatial_scale), int(sampling_ratio),
                        int(max_samples))
    tmp = torch.einsum("bnph,bchw->bnpcw", w_y, features)
    return torch.einsum("bnpcw,bnqw->bncpq", tmp, w_x)


def roi_align_mean(features, rois, output_size, spatial_scale: float,
                   sampling_ratio: int = -1, max_samples: int = 2):
    """roi_align followed by the mean over the pooled grid, (B, N, C), in
    one contraction: the mean over bins commutes into the weights."""
    w_y, w_x = _weights(features, rois, tuple(output_size),
                        float(spatial_scale), int(sampling_ratio),
                        int(max_samples))
    tmp = torch.einsum("bnh,bchw->bncw", w_y.mean(-2), features)
    return torch.einsum("bncw,bnw->bnc", tmp, w_x.mean(-2))
