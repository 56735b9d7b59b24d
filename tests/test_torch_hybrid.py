"""The port's Mamba2 (``ssd_scan``, ``mamba2_init``, ``mamba2_apply``) and
hybrid-family LM (Zamba2) against the reference's, on the CPU.

Inputs come from numpy seeds; the reference's weights cross over through
``to_tensor`` and ``lm_params_from_reference``, bit for bit.  Limits:

- ``ssd_scan``, ``mamba2_apply`` and the LM in fp32: 1e-4, the reference's
  limit for its SSD scan against a float64 recurrence (``tests/test_ssm.py``);
  the port's scan is also held to that recurrence;
- the functions in bf16: 3e-2 (one bf16 rounding of the activations is
  4e-3; the reference's bf16 serving limit);
- the LM in bf16: 6e-2, the other LM files' ``TOL_LM``;
- the port's own prefill-then-step consistency: 2e-3, as
  ``tests/test_ssm.py`` holds the reference's.

The port applies the factor of each of the reference's three-operand
einsums first and then contracts two operands, where XLA picks its own
order: the two agree to fp32 rounding, not bit for bit.
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

ARCH = "zamba2_2p7b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_LM = {"float32": 1e-4, "bfloat16": 6e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# S exceeds the smoke config's chunk of 16, so the prefills of S and S + 3
# tokens both pad their last chunk
B, S = 2, 20
# the d_model of the narrow variants at Zamba2's own SSM widths (d_state 64,
# headdim 64, chunk 128): d_inner 256, 4 heads
NARROW_D = 128
FP32_MAX_LOG = float(np.log(np.finfo(np.float32).max))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


# the reference's functions, compiled once a shape (its ops one by one take seconds)
_ref_init = jax.jit(rssm.mamba2_init, static_argnums=(1, 2, 3))
_ref_scan = jax.jit(rssm.ssd_scan, static_argnames="chunk")
_ref_apply = jax.jit(rssm.mamba2_apply, static_argnames="cfg")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    """``got`` a tensor; ``want`` a tensor or a (jax or numpy) array."""
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _ssm_cfgs(which):
    """(d_model, port SSMConfig, reference SSMConfig): the smoke config's,
    or Zamba2's own on a narrow d_model."""
    if which == "smoke":
        return configs.smoke(ARCH).d_model, configs.smoke(ARCH).ssm, rconfigs.smoke(ARCH).ssm
    return NARROW_D, configs.get(ARCH).ssm, rconfigs.get(ARCH).ssm


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


def naive_ssd(xh, dt, a_log, Bm, Cm, s0=None):
    """The recurrence s_t = exp(dt_t a) s_{t-1} + (dt_t x_t) (x) B_t,
    y_t = s_t . C_t in float64, one step at a time (tests/test_ssm.py's)."""
    Bn, T, H, Pd = xh.shape
    s = np.zeros((Bn, H, Pd, Bm.shape[-1])) if s0 is None else s0.astype(np.float64)
    ys = np.zeros((Bn, T, H, Pd))
    for t in range(T):
        a = np.exp(dt[:, t] * a_log)
        xb = xh[:, t] * dt[:, t, :, None]
        s = s * a[..., None, None] + np.einsum("bn,bhp->bhpn", Bm[:, t], xb)
        ys[:, t] = np.einsum("bn,bhpn->bhp", Cm[:, t], s)
    return ys, s


def _ssd_inputs(T, seed, Bn=2, H=3, Pd=4, N=5, dt=(0.01, 0.3), a=(0.5, 2.0)):
    """tests/test_ssm.py's ranges: x, B, C normal; dt uniform in ``dt``;
    a_log = -uniform(``a``)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bn, T, H, Pd)).astype(np.float32),
            rng.uniform(*dt, (Bn, T, H)).astype(np.float32),
            -rng.uniform(*a, (H,)).astype(np.float32),
            rng.standard_normal((Bn, T, N)).astype(np.float32),
            rng.standard_normal((Bn, T, N)).astype(np.float32))


def _check_scan(inputs, chunk, s0=None):
    y, s = ssm.ssd_scan(*map(torch.from_numpy, inputs), chunk=chunk,
                        s0=None if s0 is None else torch.from_numpy(s0))
    Bn, T, H, Pd = inputs[0].shape
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (Bn, T, H, Pd) and s.shape == (Bn, H, Pd, inputs[3].shape[-1])
    yr, sr = _ref_scan(*map(jnp.asarray, inputs), chunk=chunk,
                       s0=None if s0 is None else jnp.asarray(s0))
    yn, sn = naive_ssd(*inputs, s0=s0)
    for name, got, want in (("y vs reference", y, yr), ("s vs reference", s, sr),
                            ("y vs recurrence", y, yn), ("s vs recurrence", s, sn)):
        _close(got, want, TOL["float32"], name)
    return y, s


@pytest.mark.parametrize("T,chunk", [(16, 4), (12, 12), (20, 7)])
def test_ssd_scan_matches_reference_and_recurrence(T, chunk):
    _check_scan(_ssd_inputs(T, 1), chunk)


def test_ssd_scan_at_zamba2_widths():
    """d_state 64, headdim 64 and chunk 128 (two heads), T = 130: two
    chunks, the second padded by 126 steps."""
    cfg = configs.get(ARCH).ssm
    _check_scan(_ssd_inputs(130, 2, Bn=1, H=2, Pd=cfg.headdim, N=cfg.d_state), cfg.chunk)


def test_ssd_scan_carries_s0():
    """A scan of the second half from the first half's state is the whole
    scan's second half, and the reference's and the recurrence's with the
    same ``s0``."""
    inputs = _ssd_inputs(23, 4)
    whole_y, whole_s = ssm.ssd_scan(*map(torch.from_numpy, inputs), chunk=5)
    first = [a[:, :11] if a.ndim > 1 else a for a in inputs]
    second = [a[:, 11:] if a.ndim > 1 else a for a in inputs]
    _, s1 = ssm.ssd_scan(*map(torch.from_numpy, first), chunk=5)
    y2, s2 = _check_scan(second, 5, s0=s1.numpy())
    _close(y2, whole_y[:, 11:], 1e-5)
    _close(s2, whole_s, 1e-5)


def test_ssd_chunk_invariance():
    """The chunked scan is exact: its result does not depend on the chunk."""
    inputs = [torch.from_numpy(a) for a in _ssd_inputs(24, 3, Bn=1)]
    outs = [ssm.ssd_scan(*inputs, chunk=c) for c in (3, 8, 24, 128)]
    for y, s in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(s, outs[0][1], rtol=1e-5, atol=1e-5)


def test_ssd_scan_masks_the_overflow_above_the_diagonal():
    """dt |a| up to 16 a step: within a chunk of 16, exp(cum_i - cum_j)
    above the diagonal (j > i) passes fp32's largest value and is inf.  The
    port drops it with ``where`` as the reference does, so y and s are
    finite and match the reference and the recurrence (a product with a
    0/1 mask would give inf . 0 = NaN)."""
    inputs = _ssd_inputs(32, 5, dt=(1.0, 2.0), a=(4.0, 8.0))
    dt, a_log = inputs[1], inputs[2]
    cum = np.cumsum((dt * a_log)[:, :16], axis=1)               # the first chunk
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # [b, i, j, h] = cum_i - cum_j
    upper = np.triu(np.ones((16, 16), bool), 1)[None, :, :, None]
    assert diff.max(where=upper, initial=0.0) > FP32_MAX_LOG    # exp overflows for some j > i
    y, s = _check_scan(inputs, 16)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


# ---------------------------------------------------------------------------
# mamba2_init and mamba2_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "zamba2_inner"])
def test_mamba2_init_names_shapes_dtypes_match_reference(which):
    d, cfg, rcfg = _ssm_cfgs(which)
    want = _np(_ref_init(jax.random.PRNGKey(0), d, rcfg, jnp.bfloat16))
    got = ssm.mamba2_init(torch.Generator().manual_seed(0), d, cfg, torch.bfloat16)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == w.dtype.name, name
    for name in ("A_log", "D", "norm_w"):
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
    assert not got["conv_b"].float().any()
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which,T", [("smoke", 20), ("zamba2_inner", 130)])
def test_mamba2_apply_matches_reference(which, T, dtype):
    """The prefill form (outputs and the state it returns) and the one-token
    form from that state (output and next state)."""
    d, cfg, rcfg = _ssm_cfgs(which)
    params = _np(_ref_init(jax.random.PRNGKey(1), d, rcfg, JNP[dtype]))
    p = {k: to_tensor(v) for k, v in params.items()}
    u = jnp.asarray(np.random.default_rng(5).standard_normal((2, T + 1, d)), JNP[dtype])
    tu = to_tensor(np.asarray(u))
    ry, rst = _ref_apply(params, u[:, :T], cfg=rcfg)
    ry1, rst1 = _ref_apply(params, u[:, T:], cfg=rcfg, state=rst)
    y, st = ssm.mamba2_apply(p, tu[:, :T], cfg=cfg)
    assert y.dtype == TORCH[dtype] and st["ssm"].dtype == torch.float32
    assert st["conv"].dtype == TORCH[dtype]
    y1, st1 = ssm.mamba2_apply(p, tu[:, T:], cfg=cfg, state=st)
    tol = TOL[dtype]
    for name, g, w in (("y", y, ry), ("ssm", st["ssm"], rst["ssm"]),
                       ("conv", st["conv"], rst["conv"]), ("y1", y1, ry1),
                       ("ssm1", st1["ssm"], rst1["ssm"]), ("conv1", st1["conv"], rst1["conv"])):
        assert tuple(g.shape) == tuple(w.shape), name
        _close(g, w, tol, name)


def test_mamba2_prefill_then_step_consistency():
    """The port alone: a chunked prefill then a step equals one longer
    chunked pass (tests/test_ssm.py's check of the reference)."""
    cfg = SSMConfig(kind="mamba2", d_state=4, d_conv=4, expand=2, headdim=4, chunk=8)
    d, T = 8, 12
    p = ssm.mamba2_init(torch.Generator().manual_seed(0), d, cfg, torch.float32)
    u = torch.from_numpy(np.random.default_rng(1).standard_normal((2, T + 1, d)).astype(
        np.float32))
    full, _ = ssm.mamba2_apply(p, u, cfg=cfg)
    pre, st = ssm.mamba2_apply(p, u[:, :T], cfg=cfg)
    step, _ = ssm.mamba2_apply(p, u[:, T:], cfg=cfg, state=st)
    torch.testing.assert_close(step[:, 0], full[:, T], rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(pre, full[:, :T], rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# the hybrid-family LM
# ---------------------------------------------------------------------------


def _pair(mesh, dtype, opt, seed=3):
    """(reference LM, its params, port LM holding the same weights) on
    Zamba2's smoke config."""
    rcfg = dataclasses.replace(rconfigs.smoke(ARCH), dtype=dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1,
                 perf=rlm.OPTIMIZED if opt else rlm.PerfFlags())
    with set_mesh(mesh):
        params = _np(ref.init_params(jax.random.PRNGKey(seed)))
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(), device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, params), strict=True)
    return ref, params, port


def _leaves(cache):
    """{"k", "v", "states.ssm", "states.conv"}: the cache's leaves by path."""
    return {**{k: cache[k] for k in ("k", "v")},
            **{f"states.{k}": v for k, v in cache["states"].items()}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_zamba2_lm_matches_reference(mesh, opt, dtype):
    """Prefill logits and every cache leaf (the shared block's k and v a
    group, each layer's Mamba2 states), 3 teacher-forced decode steps
    (logits and the cache after them), and a prefill of S + 3 tokens."""
    ref, params, port = _pair(mesh, dtype, opt)
    cfg = port.cfg
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=S + 3))
        decode = jax.jit(ref.decode_step)
        rcache, rlg = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
        want = [rlg[:, 0]]
        want_cache = [_leaves(_np(rcache))]
        for t in range(3):
            rcache, rlg = decode(params, rcache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
            want.append(rlg)
        want_cache.append(_leaves(_np(rcache)))
        want.append(prefill(params, {"tokens": jnp.asarray(toks)})[1][:, 0])

    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S]}, max_len=S + 3)
    G, J, s = cfg.n_layers // cfg.attn_every, cfg.attn_every, cfg.ssm
    di = s.expand * cfg.d_model
    kv = ((G, B, cfg.n_kv_heads, S + 3, cfg.resolved_head_dim) if opt
          else (G, B, S + 3, cfg.n_kv_heads, cfg.resolved_head_dim))
    assert {k: (tuple(v.shape), v.dtype) for k, v in _leaves(cache).items()} == {
        "k": (kv, TORCH[dtype]), "v": (kv, TORCH[dtype]),
        "states.ssm": ((G, J, B, di // s.headdim, s.headdim, s.d_state), torch.float32),
        "states.conv": ((G, J, B, s.d_conv - 1, di + 2 * s.d_state), TORCH[dtype])}
    got, got_cache = [lg[:, 0]], [{k: v.clone() for k, v in _leaves(cache).items()}]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], S + i)
        got.append(lg)
    got_cache.append(_leaves(cache))
    got.append(port.prefill({"tokens": t})[1][:, 0])

    tol = TOL_LM[dtype]
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, cfg.vocab), name
        _close(g, w, tol, name)
    for when, g, w in zip(("prefill", "decode"), got_cache, want_cache):
        assert set(g) == set(w)
        for key in w:
            _close(g[key], w[key], tol, f"{when} {key}")
    # teacher-forced decode reproduces the longer prefill, in the port alone
    torch.testing.assert_close(got[3], got[4], rtol=tol, atol=tol)


def test_converter_carries_every_weight_bit_for_bit(mesh):
    """The (groups, layers, ...) blocks unstacked, the shared block passed
    through; bf16 weights and the fp32 norms, ``dt_bias``, ``A_log``, ``D``
    and ``norm_w`` bit for bit under ``strict=True``."""
    _, params, port = _pair(mesh, "bfloat16", True)
    cfg = port.cfg
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(cfg, params))
    G, J = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert len(port.blocks) == G and all(len(g) == J for g in port.blocks)

    def same(got, want, name):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, name
        bits = (lambda a: a.view(torch.int16).numpy().view(np.uint16)) \
            if got.dtype == torch.bfloat16 else (lambda a: a.numpy())
        np.testing.assert_array_equal(bits(got), want.view(np.uint16)
                                      if want.dtype.name == "bfloat16" else want, err_msg=name)

    for g in range(G):
        for j in range(J):
            for part in ("ln", "mamba"):
                for name, want in params["blocks"][part].items():
                    same(sd[f"blocks.{g}.{j}.{part}.{name}"], want[g, j], f"{g}.{j}.{name}")
    for name in ("dt_bias", "A_log", "D", "norm_w"):
        assert sd[f"blocks.0.0.mamba.{name}"].dtype == torch.float32, name
    flat = {}
    for key, sub in params["shared"].items():
        if isinstance(sub, dict):
            flat.update({f"{key}.{k}": v for k, v in sub.items()})
        else:
            flat[key] = sub
    for name, want in flat.items():
        same(sd[f"shared.{name}"], want, f"shared.{name}")
    assert sd["shared.w_in"].shape == (2 * cfg.d_model, cfg.d_model)
    same(sd["lm_head"], params["lm_head"], "lm_head")


def test_zamba2_is_the_hybrid_family_at_full_size():
    """``not_ported`` takes the hybrid family; Zamba2-2.7B's layout: 9
    groups of 6 Mamba2 layers and one shared block, counted from one full
    width Mamba2 layer and the shared block: the reference's parameters."""
    cfg = configs.get(ARCH)
    assert lm.not_ported(cfg) is None
    G, J = cfg.n_layers // cfg.attn_every, cfg.attn_every
    assert (G, J) == (9, 6)
    gen = torch.Generator().manual_seed(0)
    block = lm.SSMBlock(cfg, gen, torch.bfloat16)
    shared = lm.Block(cfg, gen, torch.bfloat16)
    mamba = sum(p.numel() for p in block.parameters())
    d = cfg.d_model
    total = (G * J * mamba + sum(p.numel() for p in shared.parameters()) + 2 * d * d
             + 2 * cfg.vocab * d + d + d)
    # the reference's own leaves, counted from its init's shapes
    assert total == 2_409_708_960


def test_hybrid_lm_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(configs.smoke(ARCH))


def test_hybrid_smoke_config_serves_and_repeats_bitwise():
    """Zamba2's smoke LM from seeded weights under the optimized flags:
    finite logits, two prefills bitwise equal (logits and every cache
    leaf), a decode step that writes the cache in place at ``cur_len`` and
    refuses a ``cur_len`` past the cache; no K6 launch on the CPU."""
    cfg = configs.smoke(ARCH)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    before = sum(flash_ops.launches.values())
    c1, lg1 = port.prefill({"tokens": toks}, max_len=S + 1)
    c2, lg2 = port.prefill({"tokens": toks}, max_len=S + 1)
    assert torch.equal(lg1, lg2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(c1).values(), _leaves(c2).values()))
    _, lg3 = port.decode_step(c1, lg1[:, 0].argmax(-1), S)
    assert lg1.shape == (B, 1, cfg.vocab) and lg3.shape == (B, cfg.vocab)
    assert torch.isfinite(lg1).all() and torch.isfinite(lg3).all()
    assert not torch.equal(c1["states"]["ssm"], c2["states"]["ssm"])  # written in place
    assert c1["k"][:, :, :, S].abs().sum() > 0 and not c2["k"][:, :, :, S].any()
    with pytest.raises(ValueError, match="cur_len"):
        port.decode_step(c1, lg1[:, 0].argmax(-1), S + 1)
    assert sum(flash_ops.launches.values()) == before


def test_serve_takes_a_built_hybrid_lm(capsys):
    """``serve_lm.main`` serves Zamba2's smoke config on the CPU, and
    ``serve_lm.serve`` on a hybrid LM built by the caller is its loop: the
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
