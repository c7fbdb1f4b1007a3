"""Vector math.

Counterpart of ``oryx_tpu/ops/vectors.py`` (reference: VectorMath.java —
dot, norm, cosineSimilarity, transposeTimesSelf :95, randomVectorF).
The functions take tensors or array-likes and compute in float32 on the
tensor's device; ``V^T V`` of a dense factor block is one matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.rand import RandomManager

__all__ = [
    "dot", "norm", "cosine_similarity", "transpose_times_self",
    "random_vector_f",
]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def dot(x, y) -> torch.Tensor:
    return torch.dot(_f32(x), _f32(y))


def norm(x) -> torch.Tensor:
    return torch.linalg.norm(_f32(x))


def cosine_similarity(x, y, norm_x_y=None) -> torch.Tensor:
    """Cosine similarity; the caller may pass a precomputed
    ``||x|| * ||y||`` (reference: VectorMath.cosineSimilarity with its
    normXY argument)."""
    x, y = _f32(x), _f32(y)
    if norm_x_y is None:
        norm_x_y = torch.linalg.norm(x) * torch.linalg.norm(y)
    return torch.dot(x, y) / norm_x_y


def transpose_times_self(v) -> torch.Tensor:
    """``V^T @ V`` of an (n, k) block of row vectors, in float32."""
    v = _f32(v)
    return v.T @ v


def random_vector_f(features: int,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Random standard-normal float32 vector (reference:
    VectorMath.randomVectorF); the same generator state gives the
    reference package's vector."""
    rng = rng or RandomManager.random()
    return rng.standard_normal(features).astype(np.float32)
