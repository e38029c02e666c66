"""Tests of the port that need the card: the CUDA kernels have no CPU mode.
They skip without a CUDA device. On a machine with an H100:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks at full width and more."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import RunKnobs, get_model

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=3e-5, rtol=3e-5), torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,KVH,D,window", [
    (2, 128, 128, 8, 2, 64, None),
    (1, 96, 200, 4, 1, 128, None),
    (2, 128, 128, 4, 2, 64, 16),
])
def test_flash_kernel_matches_plain(gen, dtype, B, Sq, Sk, H, KVH, D, window):
    q = randn(gen, B, Sq, H, D, dtype=dtype)
    k, v = randn(gen, B, Sk, KVH, D, dtype=dtype), randn(gen, B, Sk, KVH, D, dtype=dtype)
    ops.reset_launches()
    out = ops.flash_attention(q, k, v, window=window, q_offset=Sk - Sq)
    assert ops.LAUNCHES["flash_attention"] == 1
    exp = ref.flash_attention(q, k, v, window=window, q_offset=Sk - Sq)
    torch.testing.assert_close(out, exp, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,D,S,window", [
    (3, 8, 2, 64, 300, None),
    (1, 4, 1, 128, 1024, None),
    (2, 4, 2, 64, 256, 64),
])
def test_decode_kernel_matches_plain(gen, dtype, B, H, KVH, D, S, window):
    q = randn(gen, B, 1, H, D, dtype=dtype)
    kc, vc = randn(gen, B, S, KVH, D, dtype=dtype), randn(gen, B, S, KVH, D, dtype=dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    ops.reset_launches()
    out = ops.decode_attention(q, kc, vc, lengths, window=window)
    assert ops.LAUNCHES["decode_attention"] == 1
    torch.testing.assert_close(out, ref.decode_attention(q, kc, vc, lengths, window=window),
                               **TOL[dtype])


def test_kernels_refuse_what_they_do_not_take(gen):
    x = randn(gen, 1, 16, 2, 32, dtype=torch.float32)          # head dim 32
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(x, x, x)
    y = randn(gen, 1, 16, 2, 64, dtype=torch.float16)           # half precision
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(y, y, y)
    z = randn(gen, 1, 16, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention(z[:, :1], z, z, torch.tensor([16], device="cuda"))


def test_two_full_width_layers_through_kernels_match_plain(gen):
    cfg = get_config("qwen1.5-0.5b").with_(n_layers=2)
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda",
                         dtype=torch.int32)
    ops.reset_launches()
    lk, ck = model.prefill(params, {"tokens": toks}, RunKnobs(), cache_len=130)
    lk2, _ = model.decode_step(params, ck, {"tokens": toks[:, :1]}, RunKnobs())
    assert ops.LAUNCHES == {"flash_attention": 2, "decode_attention": 2}
    lp, cp = model.prefill(params, {"tokens": toks}, RunKnobs(use_kernels=False), cache_len=130)
    lp2, _ = model.decode_step(params, cp, {"tokens": toks[:, :1]}, RunKnobs(use_kernels=False))
    torch.testing.assert_close(lk, lp, atol=0.08, rtol=0.05)
    torch.testing.assert_close(lk2, lp2, atol=0.08, rtol=0.05)
