"""Matrix ops of the port's inference slice (twin of
``incubator_mxnet_tpu/ops/matrix.py``): rotary position embedding."""
import torch

__all__ = ["rope_fn"]


def rope_fn(data, base=10000.0, offset=0):
    """Rotary position embedding.  data: (B_, L, D) or (B, L, H, D);
    positions run along axis 1, shifted by ``offset``.  Rotates the
    feature pairs (d, d + D/2) by position-dependent angles, so q.k
    scores depend on relative position."""
    l, d = data.shape[1], data.shape[-1]
    if d % 2:
        raise ValueError(
            f"rope needs an even feature dim (got {d}): it rotates "
            "pairs (i, i + D/2) — pick d_model/n_heads even")
    half = d // 2
    dev = data.device
    pos = torch.arange(l, dtype=torch.float32, device=dev) + offset
    inv = torch.pow(torch.tensor(float(base), device=dev),
                    -torch.arange(half, dtype=torch.float32,
                                  device=dev) / half)
    ang = pos[:, None] * inv[None, :]                # (L, D/2)
    shape = (1, l) + (1,) * (data.dim() - 3) + (half,)
    cos = torch.cos(ang).reshape(shape)
    sin = torch.sin(ang).reshape(shape)
    x1, x2 = data[..., :half], data[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(data.dtype)
