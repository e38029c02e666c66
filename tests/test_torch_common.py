"""Each op of ``repro_torch.models.common`` against its JAX counterpart in
``repro.models.common`` on the same numpy inputs.

Tolerances: float32 inputs agree to 1e-5 (the two frameworks sum in other
orders); bfloat16 inputs to one bf16 rounding step of the output
(2e-2, as the reference's own kernel tests allow)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as J
from repro_torch.models import common as T

F32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def both(x, dtype):
    """The same numpy array as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(jnp.dtype(dtype))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))
    return j, t


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(),
                               **(F32 if dtype == "float32" else BF16))


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(rng, dtype):
    x, s = rng.standard_normal((2, 5, 64)), 0.1 * rng.standard_normal(64)
    (jx, tx), (js, ts) = both(x, dtype), both(s, "float32")
    close(J.rms_norm(jx, js, 1e-6), T.rms_norm(tx, ts, 1e-6), dtype)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (64, 1_000_000.0)])
def test_rope_freqs(head_dim, theta):
    np.testing.assert_allclose(np.asarray(J.rope_freqs(head_dim, theta)),
                               T.rope_freqs(head_dim, theta).numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(rng, dtype):
    x = rng.standard_normal((2, 7, 4, 16))
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    jx, tx = both(x, dtype)
    close(J.apply_rope(jx, jnp.asarray(pos), 10_000.0),
          T.apply_rope(tx, torch.from_numpy(pos), 10_000.0), dtype)


@pytest.mark.parametrize("Sq,Sk,H,KVH,causal,window,q_offset", [
    (24, 24, 4, 4, True, None, 0),
    (24, 24, 4, 2, True, 8, 0),
    (10, 40, 8, 2, True, None, 30),
    (12, 20, 4, 1, False, None, 0),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_attention(rng, Sq, Sk, H, KVH, causal, window, q_offset, dtype):
    q = rng.standard_normal((2, Sq, H, 16))
    k, v = rng.standard_normal((2, Sk, KVH, 16)), rng.standard_normal((2, Sk, KVH, 16))
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=8, kv_block=8)
    close(J.chunked_attention(jq, jk, jv, **kw), T.chunked_attention(tq, tk, tv, **kw), dtype)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(rng, window, dtype):
    q = rng.standard_normal((3, 1, 4, 16))
    k, v = rng.standard_normal((3, 32, 2, 16)), rng.standard_normal((3, 32, 2, 16))
    lengths = np.array([32, 9, 17], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = both(q, dtype), both(k, dtype), both(v, dtype)
    close(J.decode_attention(jq, jk, jv, jnp.asarray(lengths), window=window),
          T.decode_attention(tq, tk, tv, torch.from_numpy(lengths), window=window), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(rng, dtype):
    x = rng.standard_normal((2, 3, 32))
    wg, wu = 0.2 * rng.standard_normal((32, 48)), 0.2 * rng.standard_normal((32, 48))
    wd = 0.2 * rng.standard_normal((48, 32))
    args = [both(a, dtype) for a in (x, wg, wu, wd)]
    close(J.swiglu(*[a[0] for a in args]), T.swiglu(*[a[1] for a in args]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_tokens(rng, dtype):
    table = rng.standard_normal((50, 8)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 6)).astype(np.int32)
    out = T.embed_tokens(torch.from_numpy(table), torch.from_numpy(toks), getattr(torch, dtype))
    ref = J.embed_tokens(jnp.asarray(table), jnp.asarray(toks), jnp.dtype(dtype))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(np.asarray(ref, np.float32), out.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_logits_masks_padded_vocab(rng, dtype):
    x, head = rng.standard_normal((2, 3, 16)), 0.3 * rng.standard_normal((16, 256))
    (jx, tx), (jh, th) = both(x, dtype), both(head, dtype)
    out = T.lm_logits(tx, th, 200)
    ref = J.lm_logits(jx, jh, 200)
    assert out.dtype == torch.float32
    assert (out[..., 200:] == -1e30).all()
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **F32)
