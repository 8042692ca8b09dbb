"""Fixed-shape correspondence sampling for the geometric losses.

Port of the JAX package's ``ops/sampling.py``: keep the top ``ratio`` of the
matches by score, then draw ``num`` of them uniformly with replacement. The
draw is separate from the math: the functions take the drawn indices as
tensors (``draw_indices`` makes them from a ``torch.Generator``), so a
caller can feed the same draws to the card and the CPU, or the JAX
package's own draws to a test.
"""

from __future__ import annotations

import torch

from .warp import pixel_grid


def build_matches(flow: torch.Tensor) -> torch.Tensor:
    """Flow [B,H,W,2] -> match tensor [B,N,4] of (x1, y1, x2, y2) rows, f32."""
    b, h, w, _ = flow.shape
    grid = pixel_grid(h, w, device=flow.device)[None].expand(b, h, w, 2)
    return torch.cat([grid, grid + flow.float()], dim=-1).reshape(b, h * w, 4)


def top_ratio_count(n: int, ratio: float) -> int:
    """How many of ``n`` matches ``top_ratio_sample`` keeps."""
    return max(int(ratio * n), 1)


def top_ratio_sample(match, depth, scores, ratio: float):
    """Keep the top ``ratio`` fraction of matches by score, best first.

    match [B,N,4], depth [B,N,1], scores [B,N] -> the same with
    N' = ``top_ratio_count(N, ratio)``. Ties keep the lower index first, as
    ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` leaves
    the order among ties unspecified).
    """
    k = top_ratio_count(match.shape[1], ratio)
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    return (
        torch.gather(match, 1, idx[..., None].expand(-1, -1, match.shape[-1])),
        torch.gather(depth, 1, idx[..., None].expand(-1, -1, depth.shape[-1])),
        top_scores,
    )


def random_sample(idx, match, depth):
    """The matches and depths at the drawn indices ``idx`` [B,num] (uniform
    in [0, N), with replacement)."""
    return (
        torch.gather(match, 1, idx[..., None].expand(-1, -1, match.shape[-1])),
        torch.gather(depth, 1, idx[..., None].expand(-1, -1, depth.shape[-1])),
    )


def sample_matches(idx, flow, depth, scores, ratio: float):
    """Both stages: matches [B,num,4] and their depths [B,num,1].

    flow [B,H,W,2], depth [B,H,W,1], scores [B,H,W,1]; ``idx`` [B,num] index
    the kept matches in score order.
    """
    b, h, w, _ = flow.shape
    m, d, _ = top_ratio_sample(
        build_matches(flow), depth.reshape(b, h * w, 1), scores.reshape(b, h * w), ratio
    )
    return random_sample(idx, m, d)


def draw_indices(generator: torch.Generator, shape, high: int) -> torch.Tensor:
    """Uniform int64 indices in [0, high) on the CPU from ``generator``."""
    return torch.randint(0, high, tuple(shape), generator=generator)
