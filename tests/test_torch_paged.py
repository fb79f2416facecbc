"""The port's ``PagedKVCache`` against the JAX package's (``repro.models.
kvcache.PagedKVCache``): the operations of tests/test_engine_router.py's
two cases run on both copies, with the same numpy inputs; gathers equal,
free-block counts equal, and exhaustion raises ``MemoryError``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.kvcache import PagedKVCache as JaxPaged  # noqa: E402
from repro_torch.models.kvcache import PagedKVCache  # noqa: E402


def _pair(n_blocks, block_size, n_kv, head_dim):
    return (JaxPaged(n_blocks, block_size, n_kv, head_dim, np.float32),
            PagedKVCache(n_blocks, block_size, n_kv, head_dim, torch.float32, device="cpu"))


def _gathers_equal(want, got, rid, max_seq):
    kw, vw, lw = want.gather(rid, max_seq)
    kg, vg, lg = got.gather(rid, max_seq)
    assert lg == lw
    assert kg.shape == (max_seq, got.n_kv, got.head_dim) and kg.dtype == torch.float32
    np.testing.assert_array_equal(kg.numpy(), kw)
    np.testing.assert_array_equal(vg.numpy(), vw)
    return kg, vg, lg


def test_paged_cache_matches_contiguous_and_jax():
    """tests/test_engine_router.py::test_paged_cache_matches_contiguous on both
    copies: 11 tokens appended as 6 + 5 over blocks of 4, gathered at 16."""
    jax_c, c = _pair(16, 4, 2, 8)
    rng = np.random.default_rng(1)
    k = rng.standard_normal((11, 2, 8)).astype(np.float32)
    v = rng.standard_normal((11, 2, 8)).astype(np.float32)
    for cache, conv in ((jax_c, np.asarray), (c, torch.from_numpy)):
        cache.allocate(0)
        cache.append(0, conv(k[:6]), conv(v[:6]))
        cache.append(0, conv(k[6:]), conv(v[6:]))
    kg, vg, length = _gathers_equal(jax_c, c, 0, 16)
    assert length == 11
    np.testing.assert_array_equal(kg[:11].numpy(), k)
    np.testing.assert_array_equal(vg[:11].numpy(), v)
    assert not kg[11:].any()
    assert c.n_free_blocks == jax_c.n_free_blocks == 13
    for cache in (jax_c, c):
        cache.release(0)
    assert c.n_free_blocks == jax_c.n_free_blocks == 16  # ceil(11/4) blocks back


def test_paged_cache_interleaved_requests_reuse_blocks_like_jax():
    """Two requests appending in turns, one released and its blocks taken
    by a third: the same block tables and gathers on both copies."""
    jax_c, c = _pair(8, 3, 1, 4)
    rng = np.random.default_rng(2)
    for cache in (jax_c, c):
        cache.allocate(0)
        cache.allocate(1)
    for step, (rid, t) in enumerate([(0, 2), (1, 4), (0, 3), (1, 1)]):
        k = rng.standard_normal((t, 1, 4)).astype(np.float32)
        jax_c.append(rid, k, -k)
        c.append(rid, torch.from_numpy(k), torch.from_numpy(-k))
    assert c.tables == jax_c.tables and c.lengths == jax_c.lengths
    for cache in (jax_c, c):
        cache.release(0)
        cache.allocate(2)
    k = rng.standard_normal((5, 1, 4)).astype(np.float32)
    jax_c.append(2, k, k)
    c.append(2, torch.from_numpy(k), torch.from_numpy(k))
    assert c.tables == jax_c.tables
    for rid in (1, 2):
        _gathers_equal(jax_c, c, rid, 9)


def test_paged_cache_oom():
    """tests/test_engine_router.py::test_paged_cache_oom on both copies: 5
    tokens need 3 blocks of 2 where the pool has 2."""
    for cache, zeros in ((JaxPaged(2, 2, 1, 4, np.float32), np.zeros),
                         (PagedKVCache(2, 2, 1, 4, torch.float32, device="cpu"), torch.zeros)):
        cache.allocate(0)
        with pytest.raises(MemoryError, match="exhausted"):
            cache.append(0, zeros((5, 1, 4)), zeros((5, 1, 4)))


def test_paged_cache_keeps_its_dtype():
    """The pool and the gathers hold the dtype it was built with (bf16
    here); the appended values are cast to it."""
    c = PagedKVCache(4, 2, 1, 4, torch.bfloat16, device="cpu")
    c.allocate(0)
    x = torch.randn(3, 1, 4)
    c.append(0, x, x)
    k, _, n = c.gather(0, 4)
    assert n == 3 and k.dtype == torch.bfloat16 and torch.equal(k[:3], x.to(torch.bfloat16))
