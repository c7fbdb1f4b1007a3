"""The port's LSH against the reference's: the same test seed gives the
same hyperplanes, bucket ids agree away from the hyperplanes, and the
SWAR popcount is exact over edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.app.als import lsh as jlsh
from oryx_tpu_torch.app.als import lsh as tlsh
from oryx_tpu_torch.common.rand import RandomManager as TorchRandomManager


@pytest.fixture(autouse=True)
def _port_test_seed():
    TorchRandomManager.use_test_seed()
    yield


@pytest.mark.parametrize("rate,cores", [(1.0, 8), (0.3, 8), (0.1, 8),
                                        (0.5, 32), (0.01, 4)])
def test_choose_hash_count_matches(rate, cores):
    assert tlsh.choose_hash_count(rate, cores) == \
        jlsh.choose_hash_count(rate, cores)


@pytest.mark.parametrize("rate,features", [(0.3, 16), (0.3, 250),
                                           (0.1, 8)])
def test_same_seed_same_hyperplanes(rate, features):
    j = jlsh.LocalitySensitiveHash(rate, features)
    t = tlsh.LocalitySensitiveHash(rate, features, device="cpu")
    assert (t.num_hashes, t.max_bits_differing) == \
        (j.num_hashes, j.max_bits_differing)
    np.testing.assert_array_equal(t.hyperplanes, j.hyperplanes)


@pytest.mark.parametrize("features,width", [(16, 32), (250, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_ids_agree_off_the_hyperplanes(features, width, dtype):
    j = jlsh.LocalitySensitiveHash(0.3, features)
    t = tlsh.LocalitySensitiveHash(0.3, features, device="cpu")
    rng = np.random.default_rng(features)
    v = rng.standard_normal((3000, features)).astype(np.float32)
    padded = torch.zeros((3000, width), dtype=dtype)
    padded[:, :features] = torch.from_numpy(v)
    v_eff = padded[:, :features].float().numpy()  # what the store holds
    want = np.asarray(jlsh._bucket_kernel(
        jnp.asarray(v_eff), jnp.asarray(j.hyperplanes), j.num_hashes))
    got = t.device_buckets(padded).numpy()
    # a projection within rounding of 0 may take either sign: rows with
    # any |Y·Hᵀ| < 1e-5 are exempt, every other row must agree exactly
    proj = v_eff.astype(np.float64) @ j.hyperplanes.T.astype(np.float64)
    clear = (np.abs(proj) >= 1e-5).all(axis=1)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])
    assert got.dtype == np.int32


def test_candidate_mask_matches_reference():
    j = jlsh.LocalitySensitiveHash(0.3, 8)
    t = tlsh.LocalitySensitiveHash(0.3, 8, device="cpu")
    rng = np.random.default_rng(1)
    items = rng.standard_normal((500, 8)).astype(np.float32)
    q = rng.standard_normal(8).astype(np.float32)
    jb = j.device_buckets(jnp.asarray(items))
    tb = t.device_buckets(torch.from_numpy(items))
    np.testing.assert_array_equal(
        t.candidate_mask(q, tb).numpy(),
        np.asarray(j.candidate_mask(q, jb)))


_EDGES = [0, 1, 2, 3, 0x7FFFFFFF, -1, -0x80000000, 0x55555555, -0x55555556,
          0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x7F7F7F7F, -0x7F7F7F80,
          (1 << 20) - 1, 1 << 19, 0x12345678, -0x12345678]


def test_popcount_edge_values():
    x = np.array(_EDGES, dtype=np.int32)
    rng = np.random.default_rng(0)
    x = np.concatenate([x, rng.integers(-(1 << 31), 1 << 31, 4096,
                                        dtype=np.int64).astype(np.int32)])
    got = tlsh._popcount(torch.from_numpy(x)).numpy()
    want = np.array([bin(int(v) & 0xFFFFFFFF).count("1") for v in x])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.bitwise_count(x.view(np.uint32)))
    np.testing.assert_array_equal(got, np.asarray(jlsh._popcount(
        jnp.asarray(x))))
