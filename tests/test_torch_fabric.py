"""The port's serving fabric against the JAX fabric: the same weights (the
JAX ``_build_env``'s own, bridged across) give the same greedy tokens, at a
prompt of bucket length and at a shorter one, whose next token the
reference reads at a pad position.

Token equality is checked in float32: in bfloat16 the two frameworks round
at other places, so a near-tie between the top two logits may break either
way (and the JAX weights change with PYTHONHASHSEED, so no seed can be
chosen to avoid one). The bf16 fabric is held to the model tolerance on its
logits instead."""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serve.fabric as jfab
from repro_torch.configs import get_reduced_config
from repro_torch.core.warming import ContainerRegistry, WarmCache
from repro_torch.launch.serve import serve_requests
from repro_torch.serve import fabric

ARCH = "qwen1.5-0.5b"
# every architecture the port serves: the tests below that take ``arch``
# run the recurrent two; those written for ARCH run the dense decoder
ARCHS = [ARCH, "mamba2-370m", "recurrentgemma-9b"]


def _envs(monkeypatch, dtype, arch=ARCH):
    """A JAX fabric env and a port fabric env with the same weights."""
    import jax
    jcfg = jfab.get_reduced_config(arch).with_(dtype=dtype)
    monkeypatch.setattr(jfab, "get_reduced_config", lambda arch: jcfg)
    jenv = jfab._build_env(arch, "generate", 16)
    weights = jax.tree.map(np.asarray, jenv["params"])
    tenv = fabric._build_env(arch, "generate", 16, cfg=get_reduced_config(arch).with_(
        dtype=dtype), weights=weights, device="cpu")
    return jenv, tenv


@pytest.mark.parametrize("prompt_len", [16, 11], ids=["bucket", "short"])
def test_greedy_tokens_match_jax_fabric(monkeypatch, prompt_len):
    jenv, tenv = _envs(monkeypatch, "float32")
    prompt = np.random.default_rng(prompt_len).integers(0, 128, (2, prompt_len)).astype(np.int32)
    data = {"tokens": prompt, "n_tokens": 6}
    want = jfab.serve_generate(data, jenv)
    got = fabric.serve_generate(data, tenv)
    assert isinstance(got["tokens"], np.ndarray) and got["tokens"].shape == (2, 6)
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["warm"] is False and fabric.serve_generate(data, tenv)["warm"] is True
    for fn in ("serve_prefill", "serve_decode"):
        np.testing.assert_array_equal(getattr(fabric, fn)(data, tenv)["next_token"],
                                      np.asarray(getattr(jfab, fn)(data, jenv)["next_token"]))


@pytest.mark.parametrize("arch", ARCHS[1:])
@pytest.mark.parametrize("prompt_len", [16, 11], ids=["bucket", "short"])
def test_recurrent_archs_greedy_tokens_match_jax_fabric(monkeypatch, arch, prompt_len):
    """mamba2-370m and recurrentgemma-9b through both fabrics: the port's
    kernel route (the plain scans on the CPU) against the reference's
    chunked / associative-scan route, greedy tokens equal in float32."""
    jenv, tenv = _envs(monkeypatch, "float32", arch)
    prompt = np.random.default_rng(prompt_len).integers(0, 128, (2, prompt_len)).astype(np.int32)
    data = {"tokens": prompt, "n_tokens": 6}
    got = fabric.serve_generate(data, tenv)
    np.testing.assert_array_equal(got["tokens"], np.asarray(jfab.serve_generate(data, jenv)["tokens"]))
    assert got["arch"] == arch and got["tokens"].shape == (2, 6)


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_recurrent_archs_serve_cold_then_warm(arch):
    res = serve_requests(arch, prompt_len=12, n_tokens=3, batch=2, requests=2, full=False,
                         device="cpu")
    assert [r["key"] for r in res] == [f"torch/{arch}/generate/b16"] * 2
    assert [(r["cold"], r["warm"]) for r in res] == [(True, False), (False, True)]
    assert all(r["tokens"].shape == (2, 3) and (r["tokens"] < 128).all() for r in res)


def test_bf16_fabric_logits_match_jax(monkeypatch):
    jenv, tenv = _envs(monkeypatch, "bfloat16")
    prompt = np.random.default_rng(3).integers(0, 128, (2, 11)).astype(np.int32)
    padded = fabric.pad_to_bucket(prompt)
    jl, _ = jenv["prefill"](jenv["params"], {"tokens": jnp.asarray(padded)})
    import torch
    tl, _ = tenv["prefill"](tenv["params"], {"tokens": torch.from_numpy(padded)})
    np.testing.assert_allclose(np.asarray(jl, np.float32), tl.numpy(), atol=0.08, rtol=0.05)


def test_keys_and_padding_mirror_the_reference():
    key = fabric.torch_key(ARCH, "generate", fabric.shape_bucket(300))
    assert key == f"torch/{ARCH}/generate/b512"
    assert fabric.parse_torch_key(key) == (ARCH, "generate", 512)
    assert jfab.parse_jit_key(jfab.jit_key(ARCH, "generate", 512)) == (ARCH, "generate", 512)
    with pytest.raises(ValueError):
        fabric.parse_torch_key(jfab.jit_key(ARCH))      # a JAX-warm key is not torch-warm
    with pytest.raises(ValueError):
        fabric.torch_key(ARCH, "train")
    for n in (1, 16, 17, 100):
        assert fabric.shape_bucket(n) == jfab.shape_bucket(n)
        t = np.arange(2 * n, dtype=np.int32).reshape(2, n)
        np.testing.assert_array_equal(fabric.pad_to_bucket(t), jfab.pad_to_bucket(t))


def test_warm_cache_serves_cold_then_warm():
    res = serve_requests(ARCH, prompt_len=12, n_tokens=3, batch=2, requests=3, full=False,
                         device="cpu")
    assert [r["key"] for r in res] == [f"torch/{ARCH}/generate/b16"] * 3
    assert [r["cold"] for r in res] == [True, False, False]
    assert [r["warm"] for r in res] == [False, True, True]
    assert res[0]["build_s"] > 0 and res[1]["build_s"] == 0.0
    assert all(r["tokens"].shape == (2, 3) for r in res)


def test_install_mints_environments_on_demand():
    registry = fabric.install(ContainerRegistry(), device="cpu")
    cache = WarmCache(registry)
    c, cold = cache.get_or_build(fabric.torch_key(ARCH, "prefill", 16))
    assert cold and c.env["step"] == "prefill" and c.env["device"].type == "cpu"
    out = fabric.serve_prefill({"tokens": np.zeros((1, 9), np.int32)}, c.env)
    assert out["next_token"].shape == (1,) and out["warm"] is False
    with pytest.raises(ValueError, match="bucket"):
        fabric.serve_prefill({"tokens": np.zeros((1, 40), np.int32)}, c.env)
    with pytest.raises(ValueError, match="n_tokens"):
        fabric.serve_generate({"tokens": np.zeros((1, 9), np.int32), "n_tokens": 40}, c.env)
    with pytest.raises(ValueError, match="not of arch"):
        fabric._build_env("qwen1.5-110b", "generate", 16,
                          cfg=get_reduced_config(ARCH), device="cpu")
