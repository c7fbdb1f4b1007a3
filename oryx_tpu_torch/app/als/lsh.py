"""Locality-sensitive hashing for candidate pruning in top-N scoring.

Counterpart of ``oryx_tpu/app/als/lsh.py`` (reference:
LocalitySensitiveHash.java — hash/bits-differing selection :41-124,
sign-bit hyperplane hash :142-150, Hamming-ball candidates :156-177).

All items stay in one device tensor beside a precomputed bucket id per
item; a query's candidate set is a device-side mask,
popcount(bucket XOR target) <= max_bits_differing, fused into scoring.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...common.device import resolve_device
from ...common.rand import RandomManager

__all__ = ["LocalitySensitiveHash", "choose_hash_count"]

MAX_HASHES = 20

# rows per bucketing matmul: bounds the float32 copy of a bf16 store
_BUCKET_CHUNK_ROWS = 1 << 20


def choose_hash_count(sample_rate: float, num_cores: int) -> tuple[int, int]:
    """(num_hashes, max_bits_differing) achieving approximately the target
    sample rate while keeping ~num_cores partitions in play — the
    reference's selection loop (:41-75)."""
    num_hashes = 0
    bits_differing = 0
    while num_hashes < MAX_HASHES:
        bits_differing = 0
        num_partitions_to_try = 1
        while bits_differing < num_hashes \
                and num_partitions_to_try < num_cores:
            bits_differing += 1
            num_partitions_to_try += math.comb(num_hashes, bits_differing)
        if bits_differing == num_hashes \
                and num_partitions_to_try < num_cores:
            num_hashes += 1
            continue
        if num_partitions_to_try <= sample_rate * (1 << num_hashes):
            break
        num_hashes += 1
    return num_hashes, bits_differing


def _bucket_kernel(vectors: torch.Tensor, hyperplanes: torch.Tensor,
                   num_hashes: int) -> torch.Tensor:
    """Sign-bit bucket ids (int32) for a block of vectors: one float32
    matmul + packbits.  A bf16 block is widened to float32 first, as the
    reference's promotion of bf16 x f32 does; the widening is exact."""
    weights = torch.tensor([1 << i for i in range(num_hashes)],
                           dtype=torch.int32, device=vectors.device)
    hp_t = hyperplanes.to(torch.float32).T
    out = []
    for start in range(0, vectors.shape[0], _BUCKET_CHUNK_ROWS):
        v = vectors[start:start + _BUCKET_CHUNK_ROWS].to(torch.float32)
        signs = (v @ hp_t) > 0.0
        out.append((signs.to(torch.int32) * weights).sum(
            dim=1, dtype=torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=vectors.device)
    return torch.cat(out)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """32-bit popcount of an int32 tensor, classic SWAR (torch has no
    popcount op).  The arithmetic right shifts of a signed int32 are
    masked off at every step, so negative inputs count correctly."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


class LocalitySensitiveHash:
    """Hyperplane LSH over factor vectors."""

    def __init__(self, sample_rate: float, num_features: int,
                 num_cores: int = 8, device=None):
        self.sample_rate = sample_rate
        self.num_features = num_features
        self.device = resolve_device(device)
        self._hp_dev: torch.Tensor | None = None
        self.num_hashes, self.max_bits_differing = choose_hash_count(
            sample_rate, num_cores)
        rng = RandomManager.random()
        if self.num_hashes > 0:
            # near-orthogonal hyperplanes: random Gaussian block, then QR
            # when rank allows — drawn with NumPy, exactly as the
            # reference draws them, so one seed gives one set
            g = rng.standard_normal((self.num_hashes, num_features))
            if self.num_hashes <= num_features:
                q, _ = np.linalg.qr(g.T)
                g = q.T[:self.num_hashes]
            self.hyperplanes = np.ascontiguousarray(g, dtype=np.float32)
        else:
            self.hyperplanes = np.zeros((0, num_features), dtype=np.float32)

    def set_hyperplanes(self, hyperplanes: np.ndarray) -> None:
        """Install hyperplanes carried over from another model."""
        hp = np.ascontiguousarray(hyperplanes, dtype=np.float32)
        if hp.shape != self.hyperplanes.shape:
            raise ValueError(f"hyperplanes must be {self.hyperplanes.shape}, "
                             f"got {hp.shape}")
        self.hyperplanes = hp
        self._hp_dev = None

    def _device_hyperplanes(self) -> torch.Tensor:
        if self._hp_dev is None:
            self._hp_dev = torch.from_numpy(self.hyperplanes).to(self.device)
        return self._hp_dev

    def device_buckets(self, vectors: torch.Tensor) -> torch.Tensor:
        """Bucket ids computed device-to-device (the input may be the
        serving model's whole resident item matrix)."""
        if self.num_hashes == 0:
            return torch.zeros(vectors.shape[0], dtype=torch.int32,
                               device=vectors.device)
        hp = self._device_hyperplanes()
        if hp.shape[1] != vectors.shape[1]:
            # column-padded device snapshot: zero hyperplane columns keep
            # every sign bit identical
            hp = torch.nn.functional.pad(
                hp, (0, vectors.shape[1] - hp.shape[1]))
        return _bucket_kernel(vectors, hp, self.num_hashes)

    def candidate_mask(self, query_vector: np.ndarray,
                       item_buckets: torch.Tensor) -> torch.Tensor:
        """Device-side bool mask of items within the Hamming ball of the
        query's bucket (reference getCandidateIndices :156-177 as a
        mask)."""
        if self.num_hashes == 0 \
                or self.max_bits_differing >= self.num_hashes:
            return torch.ones(item_buckets.shape, dtype=torch.bool,
                              device=item_buckets.device)
        q = torch.from_numpy(
            np.asarray(query_vector, np.float32)[None, :]).to(
                item_buckets.device)
        target = _bucket_kernel(q, self._device_hyperplanes(),
                                self.num_hashes)[0]
        diff = _popcount(torch.bitwise_xor(item_buckets, target))
        return diff <= self.max_bits_differing
