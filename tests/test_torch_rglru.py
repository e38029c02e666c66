"""RecurrentGemma in the PyTorch port against the JAX package.

- The RG-LRU wrapper's plain version (what ``ops.rglru`` runs on the CPU,
  and what the CUDA kernel is held against on the card) against the Pallas
  kernel in interpret mode and ``ref_rglru`` at the sweeps of
  ``test_kernels.py:118-141`` (f32 3e-5, bf16 2e-2), and against
  ``lax.associative_scan`` (1e-5), the reference model's own path.
- ``_blockdiag``, ``rglru_gates``, ``rglru_full``, ``rglru_step`` and the
  GELU FFN against their JAX counterparts under the same weights (f32).

Inputs are made with numpy from a seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import rglru as jrg
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import get_model, rglru
from test_torch_models import numpy_weights

F32 = dict(atol=1e-5, rtol=1e-5)


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def scan_inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, S, W))))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (2, 100, 96), (3, 17, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_rglru_matches_pallas_and_ref(B, S, W, dtype):
    a, b = scan_inputs(S, B, S, W)
    ja, jb = (jnp.asarray(v).astype(jnp.dtype(dtype)) for v in (a, b))
    ta, tb = (torch.from_numpy(v).to(getattr(torch, dtype)) for v in (a, b))
    h = ops.rglru(ta, tb)
    assert h.dtype == tb.dtype and h.shape == (B, S, W)
    for exp in (jops.rglru(ja, jb, block_s=32, block_w=64, interpret=True),
                jref.ref_rglru(ja, jb)):
        np.testing.assert_allclose(h.float().numpy(), np.asarray(exp, np.float32), **tol(dtype))


def test_plain_rglru_matches_associative_scan():
    a, b = scan_inputs(0, 2, 64, 128)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, exp = lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    h = ops.rglru(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), np.asarray(exp), **F32)


def _block(seed=7):
    """One recurrent block's weights of reduced recurrentgemma-9b (f32) on
    both sides, and an input."""
    cfg = get_reduced_config("recurrentgemma-9b").with_(dtype="float32")
    w = numpy_weights(get_model(cfg), seed)["sb"]["rec"]
    pick = lambda t: {k: pick(v) if isinstance(v, dict) else v[0, 1] for k, v in t.items()}
    w = pick(w)
    conv = lambda t, f: {k: conv(v, f) if isinstance(v, dict) else f(v) for k, v in t.items()}
    x = np.random.default_rng(seed).standard_normal((2, 21, cfg.recurrent.lru_width))
    return cfg, conv(w, jnp.asarray), conv(w, torch.from_numpy), x.astype(np.float32)


def test_blockdiag_and_gates_match_jax():
    cfg, jp, tp, x = _block()
    np.testing.assert_allclose(
        rglru._blockdiag(torch.from_numpy(x), tp["rg_a_w"], tp["rg_a_b"]).numpy(),
        np.asarray(jrg._blockdiag(jnp.asarray(x), jp["rg_a_w"], jp["rg_a_b"])), **F32)
    for got, exp in zip(rglru.rglru_gates(tp, torch.from_numpy(x)),
                        jrg.rglru_gates(jp, jnp.asarray(x))):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **F32)


def test_rglru_full_and_step_match_jax():
    cfg, jp, tp, x = _block(8)
    th, tlast = rglru.rglru_full(tp, torch.from_numpy(x))
    jh, jlast = jrg.rglru_full(jp, jnp.asarray(x))            # the associative scan
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **F32)
    # one step past the last position of a 20-token scan is position 20
    _, h19 = rglru.rglru_full(tp, torch.from_numpy(x[:, :20]), use_kernel=False)
    ty, tnew = rglru.rglru_step(tp, torch.from_numpy(x[:, 20:]), h19)
    jy, jnew = jrg.rglru_step(jp, jnp.asarray(x[:, 20:]), jnp.asarray(h19.numpy()))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), **F32)
    np.testing.assert_allclose(tnew.numpy(), tlast.numpy(), **F32)


def test_gelu_ffn_is_the_tanh_approximation():
    cfg, jp, tp, _ = _block(9)
    h = np.random.default_rng(9).standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    got = rglru._gelu_ffn(tp["ffn"], torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(jrg._gelu_ffn(jp["ffn"], jnp.asarray(h))),
                               **F32)
    exact = torch.nn.functional.gelu(torch.from_numpy(h) @ tp["ffn"]["w_gate"])
    assert not torch.allclose(exact, rglru._gelu(torch.from_numpy(h) @ tp["ffn"]["w_gate"]),
                              atol=1e-6, rtol=0)


def test_prefill_cache_is_end_aligned_and_left_padded():
    """A prompt shorter than the window leaves the first W - S cache slots
    zero, as the reference's left pad does (rglru.py:204-211)."""
    cfg = get_reduced_config("recurrentgemma-9b").with_(dtype="float32")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    W, S = cfg.recurrent.attention_window, 10
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks})
    k = cache["sb"]["attn"]["k"]
    assert k.shape == (1, 2, W, cfg.n_kv_heads, cfg.head_dim_)
    assert not k[:, :, :W - S].any() and k[:, :, W - S:].abs().sum(-1).all()
    assert "head_rec" not in cache                  # 3 layers: no leading recurrent block
    assert cache["sb"]["rec"]["h"].shape == (1, 2, 2, cfg.recurrent.lru_width)
