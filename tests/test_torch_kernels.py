"""The port's attention wrappers and their plain versions against the JAX
package: the Pallas kernels in interpret mode (``repro.kernels.ops``) and
``repro.kernels.ref.ref_attention``, at the sweeps of ``test_kernels.py``.

On the CPU a wrapper runs its plain version (``repro_torch/kernels/ref.py``),
so these tests hold the arithmetic the CUDA kernels are compared with on the
card. Tolerances are the reference's: f32 3e-5, bf16 2e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.common import decode_attention as jax_decode
from repro_torch.kernels import ops, ref


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else dict(atol=3e-5, rtol=3e-5)


def both(x, dtype):
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype)))


def close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(), **tol(dtype))


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D", [
    (1, 64, 64, 4, 4, 32),       # MHA, square
    (2, 128, 128, 8, 2, 64),     # GQA 4:1
    (1, 96, 200, 4, 1, 64),      # MQA, ragged kv
    (2, 1, 160, 8, 4, 128),      # decode-style single query
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas_and_ref(B, Sq, Sk, H, KVH, D, dtype):
    rng = np.random.default_rng(B * 1000 + Sk)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng.standard_normal(s), dtype) for s in
                                    [(B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D)])
    off = Sk - Sq
    out = ops.flash_attention(tq, tk, tv, causal=True, q_offset=off)
    close(jref.ref_attention(jq, jk, jv, causal=True, q_offset=off), out, dtype)
    close(jops.flash_attention(jq, jk, jv, causal=True, q_offset=off, block_q=64,
                               block_k=64, interpret=True), out, dtype)


@pytest.mark.parametrize("window", [16, 64])
def test_flash_attention_window(window):
    rng = np.random.default_rng(window)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng.standard_normal(s), "float32") for s in
                                    [(2, 128, 4, 32), (2, 128, 2, 32), (2, 128, 2, 32)])
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    close(jops.flash_attention(jq, jk, jv, causal=True, window=window, block_q=32,
                               block_k=32, interpret=True), out, "float32")
    close(jref.ref_attention(jq, jk, jv, causal=True, window=window), out, "float32")


def test_flash_attention_noncausal():
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng.standard_normal(s), "float32") for s in
                                    [(1, 48, 4, 64), (1, 72, 4, 64), (1, 72, 4, 64)])
    out = ops.flash_attention(tq, tk, tv, causal=False)
    close(jops.flash_attention(jq, jk, jv, causal=False, block_q=16, block_k=24,
                               interpret=True), out, "float32")


@pytest.mark.parametrize("B,H,KVH,D,S,block", [
    (2, 4, 4, 32, 128, 32),      # MHA
    (3, 8, 2, 64, 300, 64),      # GQA, ragged cache
    (1, 4, 1, 128, 1024, 256),   # MQA, long cache
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_pallas_and_jnp(B, H, KVH, D, S, block, dtype):
    rng = np.random.default_rng(S)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng.standard_normal(s), dtype) for s in
                                    [(B, 1, H, D), (B, S, KVH, D), (B, S, KVH, D)])
    lengths = rng.integers(1, S + 1, B).astype(np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    close(jax_decode(jq, jk, jv, jnp.asarray(lengths)), out, dtype)
    close(jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), block_s=block,
                                interpret=True), out, dtype)


def test_decode_attention_window():
    rng = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = (both(rng.standard_normal(s), "float32") for s in
                                    [(2, 1, 4, 64), (2, 256, 2, 64), (2, 256, 2, 64)])
    lengths = np.array([256, 100], np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths), window=64)
    close(jops.decode_attention(jq, jk, jv, jnp.asarray(lengths), window=64, block_s=64,
                                interpret=True), out, "float32")


def test_plain_flash_matches_plain_decode_at_one_query():
    """The two plain versions agree where their contracts meet: one query
    at the end of a full-length cache."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 8, 64, generator=g)
    k, v = torch.randn(2, 40, 2, 64, generator=g), torch.randn(2, 40, 2, 64, generator=g)
    a = ref.flash_attention(q, k, v, causal=True, q_offset=39)
    b = ref.decode_attention(q, k, v, torch.tensor([40, 40], dtype=torch.int32))
    torch.testing.assert_close(a, b, atol=3e-6, rtol=3e-6)


def test_cpu_wrappers_count_no_launches():
    ops.reset_launches()
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :1], q, q, torch.tensor([8], dtype=torch.int32))
    ops.ssd(q, -torch.rand(1, 8, 2), q, q, chunk=4)
    ops.rglru(torch.rand(1, 8, 16), torch.randn(1, 8, 16))
    assert ops.LAUNCHES == {"flash_attention": 0, "decode_attention": 0, "ssd_scan": 0,
                            "rglru_scan": 0}


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="several devices"):
        ops.decode_attention(q[:, :1], torch.zeros(1, 8, 2, 64), q,
                             torch.tensor([8], dtype=torch.int32))


def test_kernel_library_names_follow_sources():
    names = {n: ops.library_path(n) for n in ops.KERNELS}
    assert all(p.parent == ops.BUILD_DIR and p.name.startswith(f"lib{n}-")
               for n, p in names.items())
    for n, mod in ops.KERNELS.items():
        assert (ops.CSRC / mod.SOURCE).exists()
        src = (ops.CSRC / mod.SOURCE).read_text()
        assert all(f'extern "C" int {sym}(' in src for sym in mod.SIGNATURES)
