"""Mamba-2 in the PyTorch port against the JAX package.

- The SSD wrapper's plain version (what ``ops.ssd`` runs on the CPU, and
  what the CUDA kernel is held against on the card) and the port's chunked
  ``models/ssm.py::ssd_scan`` against the Pallas kernel in interpret mode,
  ``ref_ssd`` and the JAX chunked ``ssd_scan``, at the sweeps of
  ``test_kernels.py:146-174``, at the reference's tolerance 5e-4.
- ``causal_conv``, ``conv_step``, ``ssd_step`` and ``_gates`` against their
  JAX counterparts under the same weights (float32: 1e-5; bf16 casts only).

Inputs are made with numpy from a seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as jssm
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.models import get_model, ssm
from test_torch_models import numpy_weights

TOL = dict(atol=5e-4, rtol=5e-4)
F32 = dict(atol=1e-5, rtol=1e-5)
# (B, S, H, P, N, chunk): test_kernels.py:146-150, the chunked-scan
# comparison shape of :163-166, and the reduced config's shape
SWEEPS = [(1, 64, 2, 16, 16, 16), (2, 70, 4, 32, 64, 32), (1, 256, 2, 64, 128, 128),
          (2, 96, 2, 16, 32, 32), (2, 24, 8, 16, 16, 16)]


def ssd_inputs(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = -np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(np.float32)   # -softplus
    Bm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, H, N)).astype(np.float32)
    return x, a, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,N,chunk", SWEEPS)
def test_plain_ssd_matches_pallas_ref_and_chunked_scan(B, S, H, P, N, chunk):
    arrs = ssd_inputs(S, B, S, H, P, N)
    j, t = [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]
    y, st = ops.ssd(*t, chunk=chunk)
    y2, st2 = ssm.ssd_scan(*t, chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (B, H, P, N)
    for ye, se in (jops.ssd(*j, chunk=chunk, interpret=True), jref.ref_ssd(*j),
                   jssm.ssd_scan(*j, chunk=chunk)):
        for got in ((y, st), (y2, st2)):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ye), **TOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(se), **TOL)


def test_plain_ssd_bf16_keeps_x_dtype_and_f32_state():
    x, a, Bm, Cm = ssd_inputs(1, 1, 40, 2, 16, 16)
    t = [torch.from_numpy(v) for v in (x, a, Bm, Cm)]
    y, st = ops.ssd(t[0].bfloat16(), t[1], t[2].bfloat16(), t[3].bfloat16(), chunk=16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    ye, se = jref.ref_ssd(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(a),
                          jnp.asarray(Bm).astype(jnp.bfloat16),
                          jnp.asarray(Cm).astype(jnp.bfloat16))
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ye, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(se), **TOL)


def test_ssd_takes_head_broadcast_b_and_c():
    """The model passes B and C as views of head stride 0 (one group);
    the result equals that of the repeated copies the reference builds."""
    x, a, Bm, Cm = ssd_inputs(2, 2, 33, 4, 16, 16)
    tx, ta = torch.from_numpy(x), torch.from_numpy(a)
    b1, c1 = torch.from_numpy(Bm[:, :, :1]), torch.from_numpy(Cm[:, :, :1])
    views = ops.ssd(tx, ta, b1.expand(2, 33, 4, 16), c1.expand(2, 33, 4, 16), chunk=16)
    copies = ops.ssd(tx, ta, b1.repeat(1, 1, 4, 1), c1.repeat(1, 1, 4, 1), chunk=16)
    for v, c in zip(views, copies):
        torch.testing.assert_close(v, c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_and_conv_step_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 19, 24)).astype(np.float32)
    k = rng.standard_normal((4, 24)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jk = jnp.asarray(x).astype(jd), jnp.asarray(k).astype(jd)
    tx, tk = torch.from_numpy(x).to(td), torch.from_numpy(k).to(td)
    np.testing.assert_array_equal(ssm.causal_conv(tx, tk).float().numpy(),
                                  np.asarray(jssm.causal_conv(jx, jk), np.float32))
    jy, jw = jssm.conv_step(jx[:, :3], jk, jx[:, 3:4])
    ty, tw = ssm.conv_step(tx[:, :3], tk, tx[:, 3:4])
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), **tol)
    np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw, np.float32))
    # one step of conv_step is the last row of causal_conv over the window
    np.testing.assert_allclose(ty[:, 0].float().numpy(),
                               ssm.causal_conv(tx[:, :4], tk)[:, -1].float().numpy(), **tol)


def test_ssd_step_matches_jax_and_continues_the_scan():
    x, a, Bm, Cm = ssd_inputs(4, 2, 9, 4, 16, 8)
    j = [jnp.asarray(v) for v in (x, a, Bm, Cm)]
    t = [torch.from_numpy(v) for v in (x, a, Bm, Cm)]
    _, h8 = ssm.ssd_scan(*(v[:, :8] for v in t), chunk=4)
    y_all, h9 = ssm.ssd_scan(*t, chunk=4)
    ty, th = ssm.ssd_step(h8, t[0][:, 8], t[1][:, 8], t[2][:, 8], t[3][:, 8])
    jy, jh = jssm.ssd_step(jnp.asarray(h8.numpy()), j[0][:, 8], j[1][:, 8], j[2][:, 8],
                           j[3][:, 8])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(ty.numpy(), y_all[:, 8].numpy(), **TOL)
    np.testing.assert_allclose(th.numpy(), h9.numpy(), **TOL)


def test_proj_inputs_and_gates_match_jax():
    cfg = get_reduced_config("mamba2-370m").with_(dtype="float32")
    w = numpy_weights(get_model(cfg), 5)
    jp = {k: jnp.asarray(v) for k, v in w["blocks"].items()}
    tp = {k: torch.from_numpy(v) for k, v in w["blocks"].items()}
    jp, tp = {k: v[0] for k, v in jp.items()}, {k: v[0] for k, v in tp.items()}
    h = np.random.default_rng(6).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jin = jssm._proj_inputs(jax_reduced("mamba2-370m"), jp, jnp.asarray(h))
    tin = ssm._proj_inputs(cfg, tp, torch.from_numpy(h))
    for a, b in zip(jin, tin):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    jout = jssm._gates(jax_reduced("mamba2-370m"), jp, *jin[1:])
    tout = ssm._gates(cfg, tp, *tin[1:])
    assert tout[3].stride(2) == 0                 # B by head: a view, not a copy
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
