"""Tip-Adapter cache scoring ``((X W^T + b) L) / s`` and its gradient in
plain PyTorch: X, W and L rounded to bf16 for the products, which
accumulate in f32, phi rounded to bf16 before the second product; the
gradient as plain f32 products."""
import torch


def cache_logits_reference(x, w, b, l, s, compute_dtype=torch.float32):
    """Plain version of ``_kernel``: X, W and L cast to ``compute_dtype``,
    both products accumulate in f32, phi = X W^T + b is rounded to
    ``compute_dtype`` before the second product, then divided by s."""
    cd = compute_dtype
    phi = torch.matmul(x.to(cd).float(), w.to(cd).float().t()) + b.float()
    logits = torch.matmul(phi.to(cd).float(), l.to(cd).float())
    return logits / s.float()


def cache_logits_bwd(x, w, l, s, g):
    """``_bwd``: the gradients of ((x w^T + b) l) / s in x, w and b, as
    plain f32 products (l and s are frozen buffers)."""
    g_phi = torch.matmul(g / s, l.t())                   # (..., N, R)
    dx = torch.matmul(g_phi, w).to(x.dtype)
    flat = g_phi.reshape(-1, w.shape[0])
    dw = torch.matmul(flat.t(), x.reshape(-1, x.shape[-1])).to(w.dtype)
    return dx, dw, flat.sum(0)


class _CacheLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, l, s, compute_dtype):
        ctx.save_for_backward(x, w, l, s)
        return cache_logits_reference(x, w, b, l, s, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        dx, dw, db = cache_logits_bwd(*ctx.saved_tensors, g)
        return dx, dw, db, None, None, None


def fused_cache_logits(x, w, b, l, s, compute_dtype=torch.bfloat16):
    """x (..., N, D); w (R, D); b (R,); l (R, C); s (C,) -> (..., N, C)
    f32, differentiable in x, w and b."""
    return _CacheLogits.apply(x, w, b, l, s, compute_dtype)
