"""Whole-model parity of the PyTorch port with the JAX package under the
same (carried-across) weights: prefill logits and every decode step, for
reduced qwen1.5-0.5b (MHA, QKV bias, tied embeddings), reduced
qwen1.5-110b (GQA 4:2, QKV bias), reduced mamba2-370m (SSD) and reduced
recurrentgemma-9b (RG-LRU and local attention; its 12-token prefill is
shorter than the 16-slot window, and decode runs past it).

The weights are made with numpy from a seed at the spread each leaf's spec
gives, and handed to both sides: the JAX init seeds each leaf with
``hash(path)``, which changes with PYTHONHASHSEED.

Tolerances: float32 runs agree to 2e-4 (the two frameworks sum in other
orders); bfloat16 runs to atol 0.08 / rtol 0.05, the reference's own bound
for bf16 decode (test_models_consistency.py:60). In bf16 XLA's CPU
activations (silu, gelu, sigmoid) round differently from PyTorch's in a
third of the elements, so the bf16 bound is the reference's and no
tighter; with other weights a lone mamba2 logit can pass it, as the
reference's own test notes (test_models_consistency.py:54-57)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.models import get_model as jax_model
from repro.models.knobs import RunKnobs as JaxKnobs
from repro_torch.configs import get_reduced_config
from repro_torch.models import RunKnobs, get_model
from repro_torch.models.params import leaves_with_paths

ARCHS = ["qwen1.5-0.5b", "qwen1.5-110b", "mamba2-370m", "recurrentgemma-9b"]
TOL = {"float32": dict(atol=2e-4, rtol=2e-4), "bfloat16": dict(atol=0.08, rtol=0.05)}
B, S = 2, 24


def numpy_weights(model, seed):
    """float32 weights for ``model``'s spec, drawn with numpy: N(0, std) with
    the std of each leaf's init, constant leaves at their constant."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, spec in leaves_with_paths(model.spec()):
        if spec.init == "zeros":
            leaf = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            leaf = np.ones(spec.shape, np.float32)
        elif spec.init == "const":
            leaf = np.full(spec.shape, spec.scale, np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale if spec.init == "normal" else fan_in ** -0.5
            leaf = (rng.standard_normal(spec.shape) * std).astype(np.float32)
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _pair(arch, dtype, seed=1):
    jm = jax_model(jax_reduced(arch).with_(dtype=dtype))
    tm = get_model(get_reduced_config(arch).with_(dtype=dtype))
    weights = numpy_weights(tm, seed)
    return jm, jax.tree.map(jnp.asarray, weights), tm, tm.load(weights, device="cpu")


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32), t.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    jm, jp, tm, tp = _pair(arch, dtype)
    toks = np.random.default_rng(1).integers(0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    jk = JaxKnobs(q_block=16, kv_block=16)
    half = S // 2
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :half])}, knobs=jk, cache_len=S)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :half])}, cache_len=S)
    _close(jl, tl, dtype)
    for i in range(half, S):
        jl, jc = jm.decode_step(jp, jc, {"tokens": jnp.asarray(toks[:, i:i + 1])}, knobs=jk)
        tl, tc = tm.decode_step(tp, tc, {"tokens": torch.from_numpy(toks[:, i:i + 1])})
        _close(jl, tl, dtype)
    assert tc["pos"] == S and tc["lengths"].tolist() == [S] * B


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_own_prefill(arch):
    """The port's mirror of test_incremental_decode_matches_prefill."""
    model = get_model(get_reduced_config(arch))
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.randint(0, model.cfg.vocab_size, (B, S), generator=torch.Generator()
                         .manual_seed(4), dtype=torch.int32)
    ref, _ = model.prefill(params, {"tokens": toks})
    logits, cache = model.prefill(params, {"tokens": toks[:, :S // 2]}, cache_len=S)
    for i in range(S // 2, S):
        logits, cache = model.decode_step(params, cache, {"tokens": toks[:, i:i + 1]})
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=0.08, rtol=0.05)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_and_plain_route_agree(arch):
    """use_kernels=True (ops wrappers; their plain versions on the CPU) and
    use_kernels=False (models/common.py chunked path) are the same model."""
    model = get_model(get_reduced_config(arch).with_(dtype="float32"))
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    toks = torch.randint(0, model.cfg.vocab_size, (B, 20), generator=torch.Generator()
                         .manual_seed(6), dtype=torch.int32)
    outs = []
    for knobs in (RunKnobs(), RunKnobs(use_kernels=False, q_block=8, kv_block=8)):
        logits, cache = model.prefill(params, {"tokens": toks[:, :12]}, knobs, cache_len=20)
        steps = [logits]
        for i in range(12, 20):
            logits, cache = model.decode_step(params, cache, {"tokens": toks[:, i:i + 1]}, knobs)
            steps.append(logits)
        outs.append(torch.stack(steps))
    torch.testing.assert_close(outs[0], outs[1], atol=2e-5, rtol=2e-5)


def test_decode_past_the_cache_raises():
    model = get_model(get_reduced_config("qwen1.5-0.5b"))
    params = model.init(device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks})
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(params, cache, {"tokens": toks[:, :1]})


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model(get_reduced_config("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    assert model.init(device="cpu")["ln_f"].device.type == "cpu"
