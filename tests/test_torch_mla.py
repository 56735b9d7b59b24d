"""The port's multi-head latent attention (MLA, DeepSeek-V2) and the MLA
``LM`` against the reference's, on the CPU.

Inputs come from numpy seeds; the reference's weights cross over through
``to_tensor`` and ``lm_params_from_reference``.

Limits.  The MLA functions: fp32 rtol = atol = 1e-5 (summation order and
libm's cos/sin differ); bf16 ``tests/test_torch_moe.py``'s table, 3e-2
(each package rounds its bf16 products once, in its own order).  The
absorbed decode against the expanded one, in the port, fp32: 1e-5 (one
function, contracted in another order).  K6's plain version and the
emulation of its tensor-core design at (dqk, dv) = (192, 128) against the
reference's ``triangular_causal_attention`` (the function K6 ports on the
serving path; the reference's Pallas kernel takes one head dim): fp32
2e-4, ``tests/test_flash.py``'s limit; bf16 ``tests/test_torch_flash.py``'s
limit, one bf16 ulp of the output plus twice the bound of a rounding of p,
2^-7 |want| + 2^-8 max|v| (the reference scales q in bf16 by 1/sqrt(192),
which is inexact, where K6 scales its fp32 scores; the plain version does
not round p, the reference does under ``bf16_compute``).

The LM: DeepSeek-V2-Lite's smoke config (MLA of rank 32, heads of 16 + 8
and 16, two shared experts beside top-2 of 8, one leading dense block) in
fp32 and bf16 under the baseline and the optimized flags, as
``tests/test_torch_moe.py`` runs its shared-experts variant: fp32 1e-5,
bf16 6e-2 (that file's limit for two shared experts and a dense block,
where each package drifts from an fp32 run in its own order); the latent
cache (``ckv``, ``krope``) of the prefill and after 3 teacher-forced decode
steps at the same limits.  The reference's CPU backend leaves
``bf16_attention`` out of its optimized bf16 flags, and the port runs the
same flags.  In fp32 every expert id of every layer and step is the
reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.meshutil import make_mesh, set_mesh
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models.config import MLAConfig as RMLAConfig
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.kernels.flash import kernel as flash_kernel
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.kernels.flash import ref as flash_ref
from repro_torch.models import attention, lm, moe
from repro_torch.models.config import MLAConfig
from repro_torch.models.convert import lm_params_from_reference, to_tensor

ARCH = "deepseek_v2_lite_16b"
B, S, D = 2, 8, 48
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LM = {"float32": 1e-5, "bfloat16": 6e-2}
# (r, dn, dr, dv, heads): the smoke config's MLA and DeepSeek-V2-Lite's own
# head dims at a narrow d_model
DIMS = {"smoke": (32, 16, 8, 16, 4), "deepseek": (512, 128, 64, 128, 2)}
THETA = 1e4


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: to_tensor(v) for k, v in tree.items()}


def _as(a, dtype):
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32) if dtype == "bfloat16" else a


def _layer(dims, dtype, seed=0):
    """(reference params, port params, x (B, S, D) numpy, both MLA configs, heads)."""
    r, dn, dr, dv, H = DIMS[dims]
    kw = dict(kv_lora_rank=r, qk_nope_dim=dn, qk_rope_dim=dr, v_head_dim=dv)
    rm, m = RMLAConfig(**kw), MLAConfig(**kw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p = _np(rattn.mla_init(jax.random.PRNGKey(seed), D, H, rm, jdt))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, D)).astype(np.float32)
    return p, _torch(p), x, rm, m, H


def _pair(x, dtype):
    """x as the reference's and the port's array of ``dtype`` (the same values)."""
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        return xj, to_tensor(np.asarray(xj))
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, tol, name=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol, atol=tol,
                               err_msg=name)


def _positions(offset=0, n=S):
    pos = np.broadcast_to(np.arange(offset, offset + n, dtype=np.int32), (B, n))
    return jnp.asarray(pos), torch.from_numpy(pos.astype(np.int64))


# ---------------------------------------------------------------------------
# The MLA functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", list(DIMS))
def test_mla_init_names_shapes_and_dtypes_are_the_references(dims):
    rp, _, _, rm, m, H = _layer(dims, "bfloat16")
    p = attention.mla_init(torch.Generator().manual_seed(0), D, H, m, torch.bfloat16)
    assert sorted(p) == sorted(rp) == sorted(["wq", "w_dkv", "kv_norm", "w_uk", "w_uv", "wo"])
    for name, t in p.items():
        assert tuple(t.shape) == rp[name].shape, name
        assert str(t.dtype).removeprefix("torch.") == rp[name].dtype.name, name
    assert p["kv_norm"].dtype == torch.float32 and bool((p["kv_norm"] == 1).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", list(DIMS))
def test_latents_queries_and_expansion_match_reference(dims, dtype):
    rp, tp, x, rm, m, H = _layer(dims, dtype, seed=3)
    xj, xt = _pair(x, dtype)
    pj, pt = _positions(offset=5)
    ckv_w, krope_w = rattn.mla_latents(rp, xj, mla=rm, positions=pj, rope_theta=THETA)
    ckv, krope = attention.mla_latents(tp, xt, mla=m, positions=pt, rope_theta=THETA)
    assert ckv.dtype == xt.dtype and krope.shape == (B, S, 1, m.qk_rope_dim)
    _close(ckv, ckv_w, TOL[dtype], "c_kv")
    _close(krope, krope_w, TOL[dtype], "k_rope")
    qn_w, qr_w = rattn.mla_queries(rp, xj, n_heads=H, mla=rm, positions=pj, rope_theta=THETA)
    qn, qr = attention.mla_queries(tp, xt, n_heads=H, mla=m, positions=pt, rope_theta=THETA)
    _close(qn, qn_w, TOL[dtype], "q_nope")
    _close(qr, qr_w, TOL[dtype], "q_rope")
    # the expansion of the same latents (the reference's, carried across)
    k_w, v_w = rattn.mla_expand_kv(rp, ckv_w, krope_w, n_heads=H, mla=rm)
    k, v = attention.mla_expand_kv(tp, to_tensor(np.asarray(ckv_w)),
                                   to_tensor(np.asarray(krope_w)), n_heads=H, mla=m)
    assert k.shape == (B, S, H, m.qk_nope_dim + m.qk_rope_dim) and v.shape == (B, S, H,
                                                                               m.v_head_dim)
    assert k.is_contiguous() and v.is_contiguous()
    _close(k, k_w, TOL[dtype], "k")
    _close(v, v_w, TOL[dtype], "v")


def _latent_cache(rp, tp, x, rm, m, dtype, M):
    """The reference's latents of ``x`` padded to M positions: (jax, torch)."""
    xj, _ = _pair(x, dtype)
    ckv, krope = rattn.mla_latents(rp, xj, mla=rm, positions=_positions()[0],
                                   rope_theta=THETA)
    pad = ((0, 0), (0, M - S), (0, 0))
    ckv, krope = jnp.pad(ckv, pad), jnp.pad(krope[:, :, 0], pad)
    return (ckv, krope), (to_tensor(np.asarray(ckv)), to_tensor(np.asarray(krope)))


@pytest.mark.parametrize("dtype,bf16_compute", [("float32", False), ("float32", True),
                                                ("bfloat16", False)])
@pytest.mark.parametrize("dims", list(DIMS))
def test_absorbed_decode_matches_reference(dims, dtype, bf16_compute):
    """One token against the first 6 of 11 cached positions (the rest
    masked): the reference's and the port's absorbed decode.  The
    reference's CPU backend cannot contract bf16 operands into an fp32
    result, so ``bf16_compute`` runs on fp32 inputs (the flag's path, its
    casts then exact)."""
    rp, tp, x, rm, m, H = _layer(dims, dtype, seed=7)
    (ckv_j, krope_j), (ckv_t, krope_t) = _latent_cache(rp, tp, x, rm, m, dtype, S + 3)
    tok = np.random.default_rng(9).standard_normal((B, 1, D)).astype(np.float32)
    xj, xt = _pair(tok, dtype)
    pj, pt = _positions(offset=5, n=1)
    want = rattn.mla_decode_absorbed(rp, xj, ckv_j, krope_j, 6, n_heads=H, mla=rm,
                                     positions=pj, rope_theta=THETA,
                                     bf16_compute=bf16_compute)
    got = attention.mla_decode_absorbed(tp, xt, ckv_t, krope_t, 6, n_heads=H, mla=m,
                                        positions=pt, rope_theta=THETA,
                                        bf16_compute=bf16_compute)
    assert got.shape == (B, 1, D) and got.dtype == xt.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dims", list(DIMS))
def test_absorbed_decode_is_the_expanded_decode(dims):
    """The weight-absorbed form computes the attention over the expanded
    K and V of the same cache (fp32, in the port alone)."""
    rp, tp, x, rm, m, H = _layer(dims, "float32", seed=11)
    _, (ckv, krope) = _latent_cache(rp, tp, x, rm, m, "float32", S + 3)
    tok = torch.from_numpy(np.random.default_rng(12).standard_normal((B, 1, D))
                           .astype(np.float32))
    pos = torch.full((B, 1), 6, dtype=torch.int64)
    got = attention.mla_decode_absorbed(tp, tok, ckv, krope, 7, n_heads=H, mla=m,
                                        positions=pos, rope_theta=THETA)
    qn, qr = attention.mla_queries(tp, tok, n_heads=H, mla=m, positions=pos, rope_theta=THETA)
    k, v = attention.mla_expand_kv(tp, ckv, krope[:, :, None], n_heads=H, mla=m)
    o = attention.decode_attention(torch.cat([qn, qr], -1), k, v, 7)
    want = o.reshape(B, 1, -1) @ tp["wo"]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K6 at (dqk, dv) = (192, 128)
# ---------------------------------------------------------------------------


def _qkv_192(dtype, Sq, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((1, Sq, 4, d)).astype(np.float32) for d in (192, 192, 128)]
    if dtype == "bfloat16":
        arrs = [_as(a, dtype) for a in arrs]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return arrs, [jnp.asarray(a, jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


@pytest.mark.parametrize("Sq", [64, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_and_tiles_at_192_128_match_triangular(dtype, Sq):
    """K6's plain version (the wrapper's CPU path, no launch counted) and
    the emulation of its tensor-core order of work against the reference's
    ``triangular_causal_attention`` at MLA's head dims, 4 heads."""
    (_, _, v), (qj, kj, vj), (q, k, vt) = _qkv_192(dtype, Sq, Sq)
    want = np.asarray(rattn.triangular_causal_attention(
        qj, kj, vj, q_block=64, bf16_compute=dtype == "bfloat16"), np.float32)
    assert want.shape == (1, Sq, 4, 128)
    before = sum(flash_ops.launches.values())
    plain = flash_ops.flash_attention(q, k, vt, causal=True, block_q=64, block_k=64)
    assert sum(flash_ops.launches.values()) == before
    tiles = flash_ref.attention_tiles_ref(q, k, vt, causal=True)
    for name, got in (("plain", plain), ("tiles", tiles)):
        assert got.shape == (1, Sq, 4, 128) and got.dtype == vt.dtype, name
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=name)
        else:
            limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -8 * float(np.abs(v).max())
            assert (np.abs(got - want) <= limit).all(), (name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("dqk,dv", [(192, 192), (128, 64), (24, 16), (128, 192)])
def test_wrapper_refuses_an_uncompiled_pair(dqk, dv):
    """The kernel's binding refuses a pair of head dims it is not compiled
    for before anything is built; a compiled pair on the CPU is refused
    only for its device."""
    q = torch.zeros((1, 8, 2, dqk), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, dv), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for head dims"):
        flash_kernel.flash_attention(q, q, v, causal=True)
    assert (192, 128) in flash_kernel.PAIRS and 192 in flash_kernel.HEAD_DIMS
    q, v = torch.zeros((1, 8, 2, 192)), torch.zeros((1, 8, 2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        flash_kernel.flash_attention(q, q, v, causal=True)


# ---------------------------------------------------------------------------
# The smoke DeepSeek LM
# ---------------------------------------------------------------------------


def _lm_pair(mesh, dtype, opt, seed=3, perf=None):
    """(reference LM, its params, port LM holding the same weights)."""
    ref_flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
    if opt and dtype == "bfloat16":
        ref_flags = dataclasses.replace(ref_flags, bf16_attention=False)
    if perf is not None:
        ref_flags = dataclasses.replace(ref_flags, **perf)
    rcfg = dataclasses.replace(rconfigs.smoke(ARCH), dtype=dtype)
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=ref_flags)
    with set_mesh(mesh):
        params = ref.init_params(jax.random.PRNGKey(seed))
    port = lm.LM(cfg, q_block=4, perf=lm.PerfFlags(**dataclasses.asdict(ref_flags)),
                 device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, _np(params)), strict=True)
    return ref, params, port


def _toks(vocab):
    return np.random.default_rng(11).integers(0, vocab, (B, S + 3)).astype(np.int32)


def _caches(cache):
    """{group.key: float32 numpy copy} of a cache (either package's; the
    port's is written in place by the decode steps after it)."""
    return {f"{g}.{k}": np.asarray(jnp.asarray(v, jnp.float32)) if not isinstance(
        v, torch.Tensor) else v.float().numpy().copy() for g, c in cache.items()
        for k, v in c.items()}


def _serve_ref(mesh, ref, params, toks):
    M = S + 3
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=M))
        decode = jax.jit(ref.decode_step)
        cache, lg = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
        out, caches = [lg[:, 0]], [_caches(cache)]
        for t in range(3):
            cache, lg = decode(params, cache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
            out.append(lg)
        caches.append(_caches(cache))
        out.append(prefill(params, {"tokens": jnp.asarray(toks)})[1][:, 0])
    return [np.asarray(x, np.float32) for x in out], caches


def _serve_port(port, toks):
    M = S + 3
    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S]}, max_len=M)
    out, caches = [lg[:, 0]], [_caches(cache)]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], S + i)
        out.append(lg)
    caches.append(_caches(cache))
    out.append(port.prefill({"tokens": t})[1][:, 0])
    return [x.numpy() for x in out], caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_prefill_cache_and_decode_match_reference(mesh, monkeypatch, opt, dtype):
    ref, params, port = _lm_pair(mesh, dtype, opt)
    toks = _toks(port.cfg.vocab)
    ref_ids, port_ids = [], []
    ref_route, port_route = rmoe.route, moe.route

    def ref_hook(w, x, k):
        out = ref_route(w, x, k)
        jax.debug.callback(lambda i: ref_ids.append(np.asarray(i)), out[1])
        return out

    def port_hook(w, x, k):
        out = port_route(w, x, k)
        port_ids.append(out[1].numpy())
        return out

    monkeypatch.setattr(rmoe, "route", ref_hook)
    monkeypatch.setattr(moe, "route", port_hook)
    want, want_caches = _serve_ref(mesh, ref, params, toks)
    got, got_caches = _serve_port(port, toks)
    assert len(ref_ids) == len(port_ids) == 5 * len(port.blocks)
    if dtype == "float32":  # the callbacks' order is not promised: compare as multisets
        key = lambda a: (a.shape, a.astype(np.int64).tobytes())  # noqa: E731
        assert sorted(map(key, ref_ids)) == sorted(map(key, port_ids))
    tol = TOL_LM[dtype]
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, port.cfg.vocab), name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    for when, gc, wc in zip(("prefill", "after 3 decode steps"), got_caches, want_caches):
        assert sorted(gc) == sorted(wc) == ["blocks.ckv", "blocks.krope", "dense0.ckv",
                                            "dense0.krope"], when
        for name in gc:
            assert gc[name].shape == wc[name].shape, (when, name)
            np.testing.assert_allclose(gc[name], wc[name], rtol=tol, atol=tol,
                                       err_msg=f"{when}: {name}")
    # teacher-forced decode reproduces the longer prefill, in the port alone
    np.testing.assert_allclose(got[3], got[4], rtol=tol, atol=tol)


@pytest.mark.parametrize("hmajor", [False, True])
def test_cache_keys_and_shapes_are_the_references_under_either_layout(mesh, hmajor):
    """The latent cache has one layout whatever ``hmajor_cache`` says, in
    both packages."""
    ref, params, port = _lm_pair(mesh, "float32", False, perf={"hmajor_cache": hmajor})
    assert port.perf.hmajor_cache is hmajor
    toks = _toks(port.cfg.vocab)[:, :S]
    with set_mesh(mesh):
        want = jax.eval_shape(lambda p, b: ref.prefill(p, b, max_len=S + 2)[0], params,
                              {"tokens": jnp.asarray(toks)})
    cache, _ = port.prefill({"tokens": torch.from_numpy(toks).long()}, max_len=S + 2)
    m = port.cfg.mla
    shapes = {g: {k: tuple(v.shape) for k, v in c.items()} for g, c in cache.items()}
    assert shapes == {g: {k: v.shape for k, v in c.items()} for g, c in want.items()}
    assert shapes["blocks"] == {"ckv": (port.cfg.n_layers - 1, B, S + 2, m.kv_lora_rank),
                                "krope": (port.cfg.n_layers - 1, B, S + 2, m.qk_rope_dim)}
    assert shapes["dense0"]["ckv"] == (1, B, S + 2, m.kv_lora_rank)


def test_decode_forms_agree_on_one_cache():
    """The LM's absorbed step and its expanded step (``absorbed=False``) on
    copies of one cache, fp32: the same logits, the same latents written
    (bitwise in the first layer, whose input is the token's embedding)."""
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    port = lm.LM(cfg, q_block=4, device="cpu", seed=5)
    toks = torch.from_numpy(_toks(cfg.vocab)).long()
    cache, lg = port.prefill({"tokens": toks[:, :S]}, max_len=S + 1)
    twin = {g: {k: v.clone() for k, v in c.items()} for g, c in cache.items()}
    c1, lg1 = port.decode_step(cache, toks[:, S], S)
    c2, lg2 = port.decode_step(twin, toks[:, S], S, absorbed=False)
    torch.testing.assert_close(lg1, lg2, rtol=1e-5, atol=1e-5)
    for g in c1:
        for k in c1[g]:
            torch.testing.assert_close(c1[g][k], c2[g][k], rtol=1e-5, atol=1e-5)
    assert torch.equal(c1["dense0"]["ckv"], c2["dense0"]["ckv"])
