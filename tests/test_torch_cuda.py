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
    (1, 64, 64, 4, 4, 32, None),             # the sweeps' own head dims
    (2, 128, 128, 4, 2, 16, 16),
    (2, 200, 200, 16, 1, 256, 64),           # recurrentgemma: MQA, head dim 256, window < S
    (1, 96, 96, 16, 1, 256, 2048),           # window > S
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
    (2, 4, 4, 32, 128, None),
    (2, 4, 4, 16, 300, None),
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
    x = randn(gen, 1, 16, 2, 48, dtype=torch.float32)          # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(x, x, x)
    y = randn(gen, 1, 16, 2, 64, dtype=torch.float16)           # half precision
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention(y, y, y)
    z = randn(gen, 1, 16, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="lengths"):
        ops.decode_attention(z[:, :1], z, z, torch.tensor([16], device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 16, 16), (2, 70, 4, 32, 64, 32), (1, 256, 2, 64, 128, 128),
    (2, 96, 2, 16, 32, 32), (1, 512, 4, 64, 128, 256),
])
def test_ssd_kernel_matches_plain(gen, dtype, B, S, H, P, N, chunk):
    x = randn(gen, B, S, H, P, dtype=dtype)
    a = -torch.nn.functional.softplus(randn(gen, B, S, H, dtype=torch.float32))
    Bm = randn(gen, B, S, 1, N, dtype=dtype).expand(B, S, H, N)   # one group, as the model
    Cm = randn(gen, B, S, H, N, dtype=dtype)
    ops.reset_launches()
    y, st = ops.ssd(x, a, Bm, Cm, chunk=chunk)
    assert ops.LAUNCHES["ssd_scan"] == 1
    ye, se = ref.ssd(x, a, Bm, Cm)
    tol = dict(atol=5e-4, rtol=5e-4) if dtype == torch.float32 else TOL[dtype]
    torch.testing.assert_close(y, ye, **tol)
    torch.testing.assert_close(st, se, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,W", [(1, 64, 128), (2, 100, 96), (3, 17, 64), (4, 512, 4096)])
def test_rglru_kernel_matches_plain(gen, dtype, B, S, W):
    a = torch.sigmoid(randn(gen, B, S, W, dtype=torch.float32)).to(dtype)
    b = randn(gen, B, S, W, dtype=dtype)
    ops.reset_launches()
    h = ops.rglru(a, b)
    assert ops.LAUNCHES["rglru_scan"] == 1 and h.dtype == dtype
    torch.testing.assert_close(h, ref.rglru(a, b), **TOL[dtype])


def test_two_full_width_layers_through_kernels_match_plain(gen):
    cfg = get_config("qwen1.5-0.5b").with_(n_layers=2)
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda",
                         dtype=torch.int32)
    ops.reset_launches()
    lk, ck = model.prefill(params, {"tokens": toks}, RunKnobs(), cache_len=130)
    lk2, _ = model.decode_step(params, ck, {"tokens": toks[:, :1]}, RunKnobs())
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), "flash_attention": 2,
                            "decode_attention": 2}
    lp, cp = model.prefill(params, {"tokens": toks}, RunKnobs(use_kernels=False), cache_len=130)
    lp2, _ = model.decode_step(params, cp, {"tokens": toks[:, :1]}, RunKnobs(use_kernels=False))
    torch.testing.assert_close(lk, lp, atol=0.08, rtol=0.05)
    torch.testing.assert_close(lk2, lp2, atol=0.08, rtol=0.05)


@pytest.mark.parametrize("arch,layers,want", [
    ("mamba2-370m", 2, {"ssd_scan": 2}),
    ("recurrentgemma-9b", 3, {"flash_attention": 1, "rglru_scan": 2}),   # attn, rec, rec
])
def test_full_width_recurrent_layers_through_kernels_match_plain(gen, arch, layers, want):
    cfg = get_config(arch).with_(n_layers=layers)
    model = get_model(cfg)
    params = model.init(gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda",
                         dtype=torch.int32)
    ops.reset_launches()
    lk, ck = model.prefill(params, {"tokens": toks}, RunKnobs())
    lk2, _ = model.decode_step(params, ck, {"tokens": toks[:, :1]}, RunKnobs())
    assert ops.LAUNCHES == {**dict.fromkeys(ops.KERNELS, 0), **want}
    lp, cp = model.prefill(params, {"tokens": toks}, RunKnobs(use_kernels=False))
    lp2, _ = model.decode_step(params, cp, {"tokens": toks[:, :1]}, RunKnobs(use_kernels=False))
    torch.testing.assert_close(lk, lp, atol=0.08, rtol=0.05)
    torch.testing.assert_close(lk2, lp2, atol=0.08, rtol=0.05)
