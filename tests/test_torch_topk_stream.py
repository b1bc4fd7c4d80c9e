"""The port's streaming exact top-k and leaderboard merge against the JAX
package's (``ops/topk.py::topk_dot_chunked``, ``merge_topk``).

Inputs are integer-valued in [-3, 3] at E <= 16, so every score is an exact
integer in fp32 on both sides and ties are frequent: values and ids must be
bit-identical, ties ordered by position as ``lax.top_k`` orders them
(ROADMAP.md trap c).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hm_retrieval_tpu.ops.topk import merge_topk as jax_merge_topk
from hm_retrieval_tpu.ops.topk import topk_dot_chunked as jax_topk_dot_chunked

from hm_retrieval_tpu_torch.ops import merge_topk, topk_dot_chunked


def _integers(rng, shape):
    return rng.integers(-3, 4, size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "B, N, E, k, chunk",
    [
        (4, 512, 8, 10, 128),  # k < chunk
        (3, 256, 16, 100, 64),  # k > chunk: kc = chunk, -inf slots early
        (5, 1024, 4, 300, 256),  # k > 256: the sort path of topk_pair
        (2, 96, 2, 96, 32),  # k = N, massive ties
    ],
)
def test_topk_dot_chunked_matches_jax(rng, B, N, E, k, chunk):
    q, c = _integers(rng, (B, E)), _integers(rng, (N, E))
    got_v, got_i = topk_dot_chunked(torch.tensor(q), torch.tensor(c), k,
                                    chunk_size=chunk)
    want_v, want_i = jax_topk_dot_chunked(jnp.asarray(q), jnp.asarray(c), k,
                                          chunk_size=chunk)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_topk_dot_chunked_is_the_full_stable_top_k(rng):
    q, c = _integers(rng, (6, 8)), _integers(rng, (640, 8))
    v, i = topk_dot_chunked(torch.tensor(q), torch.tensor(c), 50, chunk_size=64)
    scores = torch.tensor(q) @ torch.tensor(c).T
    want_v, want_i = torch.sort(scores, dim=1, descending=True, stable=True)
    assert torch.equal(v, want_v[:, :50])
    assert torch.equal(i.long(), want_i[:, :50])


def test_topk_dot_chunked_needs_whole_chunks():
    with pytest.raises(ValueError, match="divisible by chunk_size"):
        topk_dot_chunked(torch.zeros(2, 4), torch.zeros(100, 4), 5,
                         chunk_size=64)


@pytest.mark.parametrize("S, B, ks, k", [(3, 4, 8, 8), (4, 2, 16, 20),
                                         (2, 3, 300, 280)])
def test_merge_topk_matches_jax(rng, S, B, ks, k):
    scores = np.sort(
        rng.integers(-5, 6, size=(S, B, ks)).astype(np.float32), axis=-1
    )[..., ::-1].copy()
    ids = rng.integers(0, 1000, size=(S, B, ks)).astype(np.int32)
    got_v, got_i = merge_topk(torch.tensor(scores), torch.tensor(ids), k)
    want_v, want_i = jax_merge_topk(jnp.asarray(scores), jnp.asarray(ids), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_merge_of_chunk_leaderboards_is_the_global_top_k(rng):
    """Leaderboards of disjoint catalog shards, merged, equal one streaming
    top-k over the whole catalog (ties keep the lower shard first)."""
    q, c = _integers(rng, (4, 8)), _integers(rng, (512, 8))
    qt, ct = torch.tensor(q), torch.tensor(c)
    parts = [topk_dot_chunked(qt, ct[s:s + 128], 20, chunk_size=128)
             for s in range(0, 512, 128)]
    shard_v = torch.stack([v for v, _ in parts])
    shard_i = torch.stack([i + 128 * s for s, (_, i) in enumerate(parts)])
    got = merge_topk(shard_v, shard_i, 20)
    want = topk_dot_chunked(qt, ct, 20, chunk_size=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
