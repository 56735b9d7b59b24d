"""The port's Mamba1 (``repro_torch.models.ssm``) and SSM-family LM against
the reference's, on the CPU.

Inputs come from numpy seeds; the reference's weights cross over through
``to_tensor`` and ``lm_params_from_reference``, bit for bit.  Limits:

- the causal conv in fp32: 1e-5 (``tests/test_ssm.py``'s own);
- ``selective_scan``, ``mamba1_apply`` and the LM in fp32: 1e-4, the
  reference's limit for its scan against a float64 recurrence
  (``tests/test_ssm.py``); the scan here is also held to that recurrence;
- the functions in bf16: 3e-2 (one bf16 rounding of the activations is
  4e-3; the reference's bf16 serving limit);
- the LM in bf16: 6e-2, the MoE and MLA files' ``TOL_LM``;
- the port's own prefill-then-step consistency: 2e-3, as
  ``tests/test_ssm.py`` holds the reference's.

The port's scan runs the recurrence position by position inside a chunk,
where the reference runs ``lax.associative_scan``: the two agree to fp32
rounding, not bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.meshutil import make_mesh, set_mesh
from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import serve_lm
from repro_torch.models import lm, ssm
from repro_torch.models.config import SSMConfig
from repro_torch.models.convert import lm_params_from_reference, to_tensor

ARCH = "falcon_mamba_7b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_LM = {"float32": 1e-4, "bfloat16": 6e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# S exceeds the smoke config's chunk of 16, so the prefills of S and S + 3
# tokens both pad their last chunk
B, S = 2, 20
# the d_model of the narrow variants at Falcon-Mamba's own inner dims
NARROW_D = 32


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


# the reference's init, compiled once a shape (its ops one by one take seconds)
_ref_init = jax.jit(rssm.mamba1_init, static_argnums=(1, 2, 3))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    """``got`` a tensor; ``want`` a tensor or a (jax or numpy) array."""
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _ssm_cfgs(which):
    """(d_model, port SSMConfig, reference SSMConfig): the smoke config's,
    or Falcon-Mamba's own (d_state 16, d_conv 4, chunk 128) on a narrow
    d_model."""
    if which == "smoke":
        return configs.smoke(ARCH).d_model, configs.smoke(ARCH).ssm, rconfigs.smoke(ARCH).ssm
    return NARROW_D, configs.get(ARCH).ssm, rconfigs.get(ARCH).ssm


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 2, 10])
def test_causal_conv_tail_and_step_match_reference(T, dtype):
    """The conv, its tail (zero-padded on the left where T < K - 1) and the
    streaming step against the reference's on the same bits."""
    rng = np.random.default_rng(T)
    Bc, C, K = 2, 6, 4
    x, w, b = (jnp.asarray(rng.standard_normal(s).astype(np.float32), JNP[dtype])
               for s in ((Bc, T, C), (K, C), (C,)))
    tx, tw, tb = (to_tensor(np.asarray(a)) for a in (x, w, b))
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    got = ssm.causal_conv(tx, tw, tb)
    assert got.dtype == TORCH[dtype] and got.shape == (Bc, T, C)
    _close(got, rssm.causal_conv(x, w, b), tol, "conv")
    tail = ssm.conv_tail(tx, K)
    assert tail.shape == (Bc, K - 1, C)
    np.testing.assert_array_equal(tail.float().numpy(),
                                  np.asarray(rssm.conv_tail(x, K)).astype(np.float32))
    state, rstate = torch.zeros((Bc, K - 1, C), dtype=TORCH[dtype]), jnp.zeros((Bc, K - 1, C),
                                                                              JNP[dtype])
    for t in range(T):
        state, yt = ssm.causal_conv_step(state, tx[:, t], tw, tb)
        rstate, ryt = rssm.causal_conv_step(rstate, x[:, t], w, b)
        _close(yt, ryt, tol, f"step {t}")
        _close(yt, got[:, t], tol, f"step {t} vs conv")
        np.testing.assert_array_equal(state.float().numpy(),
                                      np.asarray(rstate).astype(np.float32))
    np.testing.assert_array_equal(state.float().numpy(), tail.float().numpy())


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------


def naive_selective_scan(x, dt, A, Bm, Cm, h0=None):
    """The recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = h_t . C_t
    in float64, one step at a time."""
    Bn, T, Di = x.shape
    h = np.zeros((Bn, Di, A.shape[-1])) if h0 is None else h0.astype(np.float64)
    ys = np.zeros((Bn, T, Di))
    for t in range(T):
        dA = np.exp(dt[:, t, :, None] * A)
        h = dA * h + dt[:, t, :, None] * Bm[:, t, None, :] * x[:, t, :, None]
        ys[:, t] = np.einsum("bin,bn->bi", h, Cm[:, t])
    return ys, h


def _scan_inputs(T, seed, Bn=2, Di=6, N=4):
    """tests/test_ssm.py's ranges: x, B, C normal; dt in [0.01, 0.2]; A in
    [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bn, T, Di)).astype(np.float32),
            rng.uniform(0.01, 0.2, (Bn, T, Di)).astype(np.float32),
            -rng.uniform(0.5, 2.0, (Di, N)).astype(np.float32),
            rng.standard_normal((Bn, T, N)).astype(np.float32),
            rng.standard_normal((Bn, T, N)).astype(np.float32))


@pytest.mark.parametrize("T,chunk", [(16, 4), (13, 5), (130, 128)])
def test_selective_scan_matches_reference_and_recurrence(T, chunk):
    inputs = _scan_inputs(T, 0)
    y, h = ssm.selective_scan(*map(torch.from_numpy, inputs), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (2, T, 6) and h.shape == (2, 6, 4)
    yr, hr = rssm.selective_scan(*map(jnp.asarray, inputs), chunk=chunk)
    yn, hn = naive_selective_scan(*inputs)
    _close(y, yr, TOL["float32"], "y vs reference")
    _close(h, hr, TOL["float32"], "h vs reference")
    _close(y, yn, TOL["float32"], "y vs recurrence")
    _close(h, hn, TOL["float32"], "h vs recurrence")


def test_selective_scan_carries_h0():
    """A scan of the second half from the first half's state is the whole
    scan's second half, and the reference's with the same ``h0``."""
    inputs = _scan_inputs(23, 4)
    whole_y, whole_h = ssm.selective_scan(*map(torch.from_numpy, inputs), chunk=5)
    first = [torch.from_numpy(a[:, :11]) if a.ndim == 3 else torch.from_numpy(a) for a in inputs]
    second = [a[:, 11:] if a.ndim == 3 else a for a in inputs]
    _, h1 = ssm.selective_scan(*first, chunk=5)
    y2, h2 = ssm.selective_scan(*map(torch.from_numpy, second), chunk=5, h0=h1)
    yr, hr = rssm.selective_scan(*map(jnp.asarray, second), chunk=5, h0=jnp.asarray(h1.numpy()))
    _close(y2, whole_y[:, 11:].numpy(), 1e-5)
    _close(h2, whole_h.numpy(), 1e-5)
    _close(y2, yr, TOL["float32"])
    _close(h2, hr, TOL["float32"])


def test_chunk_invariance():
    """The chunked scan is exact: its result does not depend on the chunk."""
    inputs = [torch.from_numpy(a) for a in _scan_inputs(24, 2, Bn=1, Di=4, N=3)]
    outs = [ssm.selective_scan(*inputs, chunk=c)[0] for c in (3, 8, 24, 128)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# mamba1_init and mamba1_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "falcon_inner"])
def test_mamba1_init_names_shapes_dtypes_match_reference(which):
    d, cfg, rcfg = _ssm_cfgs(which)
    want = _np(_ref_init(jax.random.PRNGKey(0), d, rcfg, jnp.bfloat16))
    got = ssm.mamba1_init(torch.Generator().manual_seed(0), d, cfg, torch.bfloat16)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == w.dtype.name, name
    # log(1 ... N): torch's and XLA's fp32 log differ by an ulp at some n
    np.testing.assert_allclose(got["A_log"].numpy(), want["A_log"], rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(got["D"].numpy(), want["D"])
    assert not got["conv_b"].float().any()
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which,T", [("smoke", 20), ("falcon_inner", 130)])
def test_mamba1_apply_matches_reference(which, T, dtype):
    """The prefill form (outputs and the state it returns) and the one-token
    form from that state (output and next state)."""
    d, cfg, rcfg = _ssm_cfgs(which)
    params = _np(_ref_init(jax.random.PRNGKey(1), d, rcfg, JNP[dtype]))
    p = {k: to_tensor(v) for k, v in params.items()}
    u = jnp.asarray(np.random.default_rng(5).standard_normal((2, T + 1, d)), JNP[dtype])
    tu = to_tensor(np.asarray(u))
    apply = jax.jit(rssm.mamba1_apply, static_argnames="cfg")
    ry, rst = apply(params, u[:, :T], cfg=rcfg)
    ry1, rst1 = apply(params, u[:, T:], cfg=rcfg, state=rst)
    y, st = ssm.mamba1_apply(p, tu[:, :T], cfg=cfg)
    assert y.dtype == TORCH[dtype] and st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == TORCH[dtype]
    y1, st1 = ssm.mamba1_apply(p, tu[:, T:], cfg=cfg, state=st)
    tol = TOL[dtype]
    for name, g, w in (("y", y, ry), ("ssm", st["ssm"], rst["ssm"]),
                       ("conv", st["conv"], rst["conv"]), ("y1", y1, ry1),
                       ("ssm1", st1["ssm"], rst1["ssm"]), ("conv1", st1["conv"], rst1["conv"])):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, tol, name)


def test_prefill_then_step_consistency():
    """The port alone: a chunked prefill then a step equals one longer
    chunked pass (tests/test_ssm.py's check of the reference)."""
    cfg = SSMConfig(kind="mamba1", d_state=4, d_conv=4, expand=2, headdim=4, chunk=8)
    d, T = 8, 12
    p = ssm.mamba1_init(torch.Generator().manual_seed(0), d, cfg, torch.float32)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((2, T + 1, d)).astype(
        np.float32))
    full, _ = ssm.mamba1_apply(p, u, cfg=cfg)
    pre, st = ssm.mamba1_apply(p, u[:, :T], cfg=cfg)
    step, _ = ssm.mamba1_apply(p, u[:, T:], cfg=cfg, state=st)
    torch.testing.assert_close(step[:, 0], full[:, T], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(pre, full[:, :T], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the SSM-family LM
# ---------------------------------------------------------------------------


def _pair(mesh, dtype, opt, seed=3):
    """(reference LM, its params, port LM holding the same weights) on
    Falcon-Mamba's smoke config."""
    rcfg = dataclasses.replace(rconfigs.smoke(ARCH), dtype=dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1,
                 perf=rlm.OPTIMIZED if opt else rlm.PerfFlags())
    with set_mesh(mesh):
        params = _np(ref.init_params(jax.random.PRNGKey(seed)))
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(), device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, params), strict=True)
    return ref, params, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_falcon_mamba_lm_matches_reference(mesh, opt, dtype):
    """Prefill logits and its ``{"ssm", "conv"}`` cache, 3 teacher-forced
    decode steps (logits and the cache after them), and a prefill of S + 3
    tokens."""
    ref, params, port = _pair(mesh, dtype, opt)
    cfg = port.cfg
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=S + 3))
        decode = jax.jit(ref.decode_step)
        rcache, rlg = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
        want = [rlg[:, 0]]
        want_cache = [_np(rcache)]
        for t in range(3):
            rcache, rlg = decode(params, rcache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
            want.append(rlg)
        want_cache.append(_np(rcache))
        want.append(prefill(params, {"tokens": jnp.asarray(toks)})[1][:, 0])

    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S]}, max_len=S + 3)
    di, L = cfg.ssm.expand * cfg.d_model, cfg.n_layers
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "ssm": ((L, B, di, cfg.ssm.d_state), torch.float32),
        "conv": ((L, B, cfg.ssm.d_conv - 1, di), TORCH[dtype])}
    got, got_cache = [lg[:, 0]], [{k: v.clone() for k, v in cache.items()}]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], S + i)
        got.append(lg)
    got_cache.append(cache)
    got.append(port.prefill({"tokens": t})[1][:, 0])

    tol = TOL_LM[dtype]
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, cfg.vocab), name
        _close(g, w, tol, name)
    for when, g, w in zip(("prefill", "decode"), got_cache, want_cache):
        for key in ("ssm", "conv"):
            _close(g[key], w[key], tol, f"{when} {key}")
    # teacher-forced decode reproduces the longer prefill, in the port alone
    torch.testing.assert_close(got[3], got[4], rtol=tol, atol=tol)


def test_converter_carries_every_weight_bit_for_bit(mesh):
    """The bf16 weights and the fp32 ``dt_bias``, ``A_log`` and ``D`` cross
    over bit for bit and load under ``strict=True``."""
    _, params, port = _pair(mesh, "bfloat16", True)
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(port.cfg, params))
    assert len(port.blocks) == port.cfg.n_layers
    for i in range(port.cfg.n_layers):
        assert sd[f"blocks.{i}.ln.w"].dtype == torch.float32
        for name, want in params["blocks"]["mamba"].items():
            got = sd[f"blocks.{i}.mamba.{name}"]
            want = want[i]
            if name in ("dt_bias", "A_log", "D"):
                assert got.dtype == torch.float32, name
                np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            else:
                assert got.dtype == torch.bfloat16, name
                np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                              want.view(np.uint16), err_msg=name)
    np.testing.assert_array_equal(sd["lm_head"].view(torch.int16).numpy().view(np.uint16),
                                  params["lm_head"].view(np.uint16))


def test_ssm_lm_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(configs.smoke(ARCH))


def test_ssm_smoke_config_serves_without_k6_and_repeats_bitwise():
    """Falcon-Mamba's smoke LM from seeded weights under the optimized
    flags: finite logits, a cache that ``max_len`` does not size, decode
    steps that ``cur_len`` does not bound, no K6 launch, and two prefills
    bitwise equal."""
    cfg = configs.smoke(ARCH)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    before = sum(flash_ops.launches.values())
    c1, lg1 = port.prefill({"tokens": toks}, max_len=S + 1)
    c2, lg2 = port.prefill({"tokens": toks})
    assert torch.equal(lg1, lg2) and all(torch.equal(c1[k], c2[k]) for k in ("ssm", "conv"))
    _, lg3 = port.decode_step(c1, lg1[:, 0].argmax(-1), 10 * S)
    assert lg1.shape == (B, 1, cfg.vocab) and lg3.shape == (B, cfg.vocab)
    assert torch.isfinite(lg1).all() and torch.isfinite(lg3).all()
    assert not torch.equal(c1["ssm"], c2["ssm"])  # the step wrote the cache in place
    assert sum(flash_ops.launches.values()) == before


def test_serve_takes_a_built_ssm_lm(capsys):
    """``serve_lm.main`` serves Falcon-Mamba's smoke config, and
    ``serve_lm.serve`` on an SSM LM built by the caller is its loop: the
    same seed gives the same ids and lines."""
    argv = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--opt",
            "--batch", "2", "--prompt-len", "20", "--gen", "3", "--seed", "5"]
    res = serve_lm.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={res.lm.cfg.name} batch=2 prompt=20 gen=3"
    cfg = configs.smoke(ARCH)
    built = lm.LM(cfg, q_block=20, perf=lm.OPTIMIZED, device="cpu", seed=5)
    prompts = serve_lm.make_prompts(cfg.vocab, 2, 20, "cpu", 5)
    assert torch.equal(prompts, res.prompts)
    again = serve_lm.serve(built, prompts, 3)
    assert torch.equal(again.ids, res.ids) and again.ids.shape == (2, 4)
    assert capsys.readouterr().out.strip().splitlines()[2] == lines[2]
    _, lg = built.prefill({"tokens": prompts})
    torch.testing.assert_close(res.ids[:, 0], lg[:, -1].argmax(-1))
