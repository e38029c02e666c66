"""Parameter trees and the weight bridge of the PyTorch port, against the
JAX package's specs and weights."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced_config as jax_reduced
from repro.models import get_model as jax_model
from repro.models.params import tree_paths as jax_tree_paths
from repro_torch.configs import ARCH_IDS, get_config, get_reduced_config
from repro_torch.models import get_model
from repro_torch.models.params import (
    export_params,
    leaves_with_paths,
    load_jax_params,
    tree_paths,
)

PORTED = ["qwen1.5-0.5b", "qwen1.5-110b", "phi4-mini-3.8b", "mamba2-370m", "recurrentgemma-9b"]


def test_configs_are_copies():
    for arch in ARCH_IDS:
        assert repr(get_config(arch)) == repr(jax_config(arch))
        assert repr(get_reduced_config(arch)) == repr(jax_reduced(arch))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_spec_paths_and_shapes_match_jax(arch, full):
    cfg = get_config(arch) if full else get_reduced_config(arch)
    jcfg = jax_config(arch) if full else jax_reduced(arch)
    want = {p: s.shape for p, s in jax_tree_paths(jax_model(jcfg).spec()).items()}
    got = {p: s.shape for p, s in tree_paths(get_model(cfg).spec()).items()}
    assert got == want


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_init_on_meta_device_matches_jax_shapes(full):
    """The full config is built on the meta device: nothing is allocated."""
    arch = "qwen1.5-0.5b"
    cfg = get_config(arch) if full else get_reduced_config(arch)
    jcfg = jax_config(arch) if full else jax_reduced(arch)
    params = get_model(cfg).init(device="meta")
    shapes = {p: tuple(t.shape) for p, t in leaves_with_paths(params)}
    assert all(t.is_meta for _, t in leaves_with_paths(params))
    want = {p: s.shape for p, s in jax_tree_paths(jax_model(jcfg).spec()).items()}
    assert shapes == want
    if full:
        assert get_model(cfg).param_count() == jax_model(jcfg).param_count() == 464_118_784


@pytest.mark.parametrize("arch,count", [("mamba2-370m", 420_025_856),
                                        ("recurrentgemma-9b", 8_578_412_544)])
def test_full_recurrent_families_on_meta_match_jax(arch, count):
    """Full mamba2-370m and recurrentgemma-9b (17.2 GB in bf16) built on the
    meta device: the stacked head_rec / sb trees have the JAX paths and shapes."""
    params = get_model(get_config(arch)).init(device="meta")
    shapes = {p: tuple(t.shape) for p, t in leaves_with_paths(params)}
    want = {p: s.shape for p, s in jax_tree_paths(jax_model(jax_config(arch)).spec()).items()}
    assert shapes == want
    assert get_model(get_config(arch)).param_count() == count


def test_init_is_seeded_and_cast():
    model = get_model(get_reduced_config("qwen1.5-0.5b"))
    a = model.init(torch.Generator().manual_seed(3), device="cpu")
    b = model.init(torch.Generator().manual_seed(3), device="cpu")
    for (pa, ta), (pb, tb) in zip(leaves_with_paths(a), leaves_with_paths(b)):
        assert pa == pb and ta.dtype == torch.bfloat16 and torch.equal(ta, tb)
    std = a["blocks"]["attn"]["wq"].float().std().item()
    assert 0.8 / 8 < std < 1.2 / 8          # scaled_normal: 1/sqrt(fan_in=64)
    assert not a["blocks"]["attn"]["bq"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trips(dtype):
    cfg = jax_reduced("qwen1.5-110b")
    jparams = jax_model(cfg).init(jax.random.PRNGKey(1), dtype=jnp.dtype(dtype))
    tree = jax.tree.map(np.asarray, jparams)
    ported = load_jax_params(tree, torch.device("cpu"))
    back = export_params(ported)
    for (p, a), (q, b) in zip(leaves_with_paths(tree), leaves_with_paths(back)):
        assert p == q
        if dtype == "bfloat16":
            assert b.dtype == np.uint16
            b = b.view(ml_dtypes.bfloat16)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), p


def test_load_casts_once_to_the_compute_dtype():
    cfg = jax_reduced("qwen1.5-0.5b")
    jparams = jax_model(cfg).init(jax.random.PRNGKey(2))       # float32 master weights
    tree = jax.tree.map(np.asarray, jparams)
    params = get_model(get_reduced_config("qwen1.5-0.5b")).load(tree, device="cpu")
    wq = params["blocks"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    want = np.asarray(jparams["blocks"]["attn"]["wq"].astype(jnp.bfloat16)).astype(np.float32)
    np.testing.assert_array_equal(wq.float().numpy(), want)


def test_load_refuses_weights_of_another_shape():
    tree = jax.tree.map(np.asarray, jax_model(jax_reduced("qwen1.5-110b")).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="do not fit"):
        get_model(get_reduced_config("qwen1.5-0.5b")).load(tree, device="cpu")


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "minicpm3-4b", "qwen2-vl-7b",
                                  "seamless-m4t-large-v2"])
def test_unported_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        get_model(get_reduced_config(arch))
