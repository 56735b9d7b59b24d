"""The port's audio family (SeamlessM4T: an encoder–decoder, the decoder's
blocks with cross-attention over the encoded frames) against the
reference's, on the CPU.

The reference's ``init_params`` weights cross over through
``lm_params_from_reference``; prompts and frames come from a numpy seed.
Both packages run SeamlessM4T's smoke config (2 encoder and 2 decoder
layers) through a prefill of S tokens on S frames, 3 teacher-forced decode
steps, and a prefill of S + 3 tokens on the same S frames; the reference on
a (1, 1) mesh, jitted.  Limits: the other LM files' ``TOL_LM``, fp32 1e-4
and bf16 6e-2 (the reference's serving tolerance under the optimized
flags); ``blockwise_attention`` alone fp32 1e-5 and bf16 3e-2, as
``tests/test_torch_mla.py`` holds the attention functions.  The reference's
CPU backend cannot contract bf16 operands into an fp32 result, so for bf16
its optimized flags leave out ``bf16_attention``, as
``tests/test_torch_lm.py`` does; the port runs ``OPTIMIZED`` whole.
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
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import serve_lm
from repro_torch.models import attention, lm
from repro_torch.models.config import param_count
from repro_torch.models.convert import lm_params_from_reference

ARCH = "seamless_m4t_medium"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
TOL_LM = {"float32": 1e-4, "bfloat16": 6e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 8
LEAVES = ("k", "v", "ck", "cv")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32),
                               rtol=tol, atol=tol, err_msg=msg)


def _pair(mesh, dtype, opt, seed=3):
    """(reference LM, its params, port LM holding the same weights) on
    SeamlessM4T's smoke config."""
    ref_flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
    if opt and dtype == "bfloat16":
        ref_flags = dataclasses.replace(ref_flags, bf16_attention=False)
    rcfg = dataclasses.replace(rconfigs.smoke(ARCH), dtype=dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=ref_flags)
    with set_mesh(mesh):
        params = _np(ref.init_params(jax.random.PRNGKey(seed)))
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype=dtype)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(), device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, params), strict=True)
    return ref, params, port


def _inputs(cfg, seed=11):
    """Token ids (B, S + 3) and bf16 frames (B, S, D)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return toks, torch.from_numpy(frames).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(11, 8), (8, 8), (3, 13)])
def test_cross_attention_shapes_match_reference(sq, skv, dtype):
    """Non-causal ``blockwise_attention`` with Sq != Skv (the teacher-forced
    check's S + 3 tokens on S frames, and more keys than queries), q blocks
    of 4 with a short last one, 4 q heads on 2 kv heads."""
    rng = np.random.default_rng(sq * 31 + skv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, sq, 4, 16), (B, skv, 2, 16), (B, skv, 2, 16)))
    want = rattn.blockwise_attention(*(jnp.asarray(a).astype(JNP[dtype]) for a in (q, k, v)),
                                     causal=False, q_block=4)
    got = attention.blockwise_attention(*(torch.from_numpy(a).to(TORCH[dtype])
                                          for a in (q, k, v)), causal=False, q_block=4)
    assert got.shape == (B, sq, 4, 16) and got.dtype == TORCH[dtype]
    _close(got, np.asarray(want, np.float32), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_seamless_lm_matches_reference(mesh, opt, dtype):
    """Prefill logits and every cache leaf (``k``, ``v`` of S + 3 positions,
    ``ck``, ``cv`` of S frames, in the layout ``hmajor_cache`` sets), 3
    teacher-forced decode steps (logits and the cache after them), and a
    prefill of S + 3 tokens on the same frames."""
    ref, params, port = _pair(mesh, dtype, opt)
    cfg = port.cfg
    M = S + 3
    toks, frames = _inputs(cfg)
    frames_j = jnp.asarray(frames.float().numpy()).astype(jnp.bfloat16)
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=M))
        decode = jax.jit(ref.decode_step)
        rcache, rlg = prefill(params, {"tokens": jnp.asarray(toks[:, :S]),
                                       "frontend": frames_j})
        want, want_cache = [rlg[:, 0]], [_np(rcache)]
        for t in range(3):
            rcache, rlg = decode(params, rcache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
            want.append(rlg)
        want_cache.append(_np(rcache))
        want.append(prefill(params, {"tokens": jnp.asarray(toks), "frontend": frames_j})[1][:, 0])

    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S], "frontend": frames}, max_len=M)
    L, H, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def shape(n):
        return (L, B, H, n, dh) if opt else (L, B, n, H, dh)

    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        "k": (shape(M), TORCH[dtype]), "v": (shape(M), TORCH[dtype]),
        "ck": (shape(S), TORCH[dtype]), "cv": (shape(S), TORCH[dtype])}
    got, got_cache = [lg[:, 0]], [{k: v.clone() for k, v in cache.items()}]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], S + i)
        got.append(lg)
    got_cache.append(cache)
    got.append(port.prefill({"tokens": t, "frontend": frames})[1][:, 0])

    tol = TOL_LM[dtype]
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, cfg.vocab), name
        _close(g, w, tol, name)
    for when, g, w in zip(("prefill", "decode"), got_cache, want_cache):
        assert set(g) == set(w) == set(LEAVES)
        for key in LEAVES:
            _close(g[key], w[key], tol, f"{when} {key}")
    # a decode step writes k and v in place and reads ck, cv
    for key in ("ck", "cv"):
        assert torch.equal(got_cache[0][key], got_cache[1][key]), key
    # teacher-forced decode reproduces the longer prefill, in the port alone
    torch.testing.assert_close(got[3], got[4], rtol=tol, atol=tol)


def test_converter_unstacks_encoder_and_decoder_bit_for_bit(mesh):
    """``enc_blocks`` and ``dec_blocks`` unstacked under the reference's
    names (the decoder's ``ln_x`` and ``cross`` among them), ``enc_norm``
    passed through, bf16 weights and fp32 norms bit for bit under
    ``strict=True``."""
    _, params, port = _pair(mesh, "bfloat16", True)
    cfg = port.cfg
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(cfg, params))
    assert {k.split(".")[0] for k in sd} == {"embed", "final_norm", "lm_head", "enc_blocks",
                                            "enc_norm", "dec_blocks"}
    assert len(port.enc_blocks) == cfg.n_encoder_layers and len(port.dec_blocks) == cfg.n_layers
    assert not any(".cross.b" in k for k in sd)  # the cross GQA has no qkv bias

    def bits(t):
        return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 \
            else t.numpy()

    for group in ("enc_blocks", "dec_blocks"):
        for part, leaves in params[group].items():
            for name, want in leaves.items():
                for i in range(want.shape[0]):
                    got = sd[f"{group}.{i}.{part}.{name}"]
                    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
                    np.testing.assert_array_equal(
                        bits(got), want[i].view(np.uint16) if want.dtype.name == "bfloat16"
                        else want[i], err_msg=f"{group}.{i}.{part}.{name}")
    for name in ("w", "b"):
        np.testing.assert_array_equal(sd[f"enc_norm.{name}"].numpy(), params["enc_norm"][name])


def test_converter_refuses_a_mis_stacked_encoder(mesh):
    """An ``enc_blocks`` stacked over another count of layers than the
    config's ``n_encoder_layers`` is refused, naming the group."""
    _, params, port = _pair(mesh, "float32", False)
    short = dict(params, enc_blocks=jax.tree.map(lambda a: a[:1], params["enc_blocks"]))
    with pytest.raises(ValueError, match="enc_blocks"):
        lm_params_from_reference(port.cfg, short)
    cut = dataclasses.replace(port.cfg, n_encoder_layers=3)
    with pytest.raises(ValueError, match="enc_blocks"):
        lm_params_from_reference(cut, params)


def test_seamless_is_the_audio_family_at_full_size():
    """SeamlessM4T-medium whole: 12 encoder and 12 decoder layers at d 1024,
    16 / 16 heads of 64, an untied head over 256,206 ids; its parameters
    counted from one full-width encoder and one decoder block: the
    reference's ``init_params`` leaves (from their abstract shapes), 64,512
    above ``param_count``, which counts each layernorm as d and leaves out
    ``enc_norm`` and ``final_norm``."""
    cfg = configs.get(ARCH)
    ref = rlm.LM(rconfigs.get(ARCH), make_mesh((1, 1), ("data", "model")),
                 Axes(multi_pod=False))
    leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(ref.abstract_params()))
    assert lm.not_ported(cfg) is None
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model) == (12, 12, 1024)
    gen = torch.Generator().manual_seed(0)
    enc = sum(p.numel() for p in lm.Block(cfg, gen, torch.bfloat16).parameters())
    dec = sum(p.numel() for p in lm.Block(cfg, gen, torch.bfloat16, cross=True).parameters())
    d, v = cfg.d_model, cfg.vocab
    total = cfg.n_encoder_layers * enc + cfg.n_layers * dec + 2 * v * d + 4 * d
    assert total == leaves == 877_158_400
    assert param_count(cfg) == 877_093_888


def test_audio_lm_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(configs.smoke(ARCH))


def test_audio_smoke_config_serves_and_repeats_bitwise():
    """SeamlessM4T's smoke LM from seeded weights under the optimized flags:
    two prefills bitwise equal (logits and every cache leaf); the frames
    reach the logits; a decode step writes ``k`` at ``cur_len`` in place,
    leaves ``ck`` as it was, and one past the cache is refused; the
    decoder's self-attention is the only K6 call, once a layer, and on the
    CPU counts no launch."""
    cfg = configs.smoke(ARCH)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks, frames = _inputs(cfg, seed=2)
    batch = {"tokens": torch.from_numpy(toks[:, :S]).long(), "frontend": frames}
    calls, kern = [], flash_ops.flash_attention

    def counted(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return kern(q, k, v, **kw)

    before = sum(flash_ops.launches.values())
    flash_ops.flash_attention = counted
    try:
        c1, lg1 = port.prefill(batch, max_len=S + 1)
    finally:
        flash_ops.flash_attention = kern
    assert calls == [(B, S, cfg.n_heads, cfg.head_dim)] * cfg.n_layers
    c2, lg2 = port.prefill(batch, max_len=S + 1)
    assert torch.equal(lg1, lg2) and all(torch.equal(c1[k], c2[k]) for k in LEAVES)
    _, lg_other = port.prefill(dict(batch, frontend=torch.zeros_like(frames)), max_len=S + 1)
    assert not torch.allclose(lg1, lg_other)
    _, lg3 = port.decode_step(c1, lg1[:, 0].argmax(-1), S)
    assert lg1.shape == (B, 1, cfg.vocab) and lg3.shape == (B, cfg.vocab)
    assert torch.isfinite(lg1).all() and torch.isfinite(lg3).all()
    assert c1["k"][:, :, :, S].abs().sum() > 0 and not c2["k"][:, :, :, S].any()
    assert torch.equal(c1["ck"], c2["ck"]) and torch.equal(c1["cv"], c2["cv"])
    with pytest.raises(ValueError, match="cur_len"):
        port.decode_step(c1, lg1[:, 0].argmax(-1), S + 1)
    assert sum(flash_ops.launches.values()) == before


def test_serve_takes_a_built_audio_lm(capsys):
    """``serve_lm.main`` serves SeamlessM4T's smoke config on the CPU with S
    seeded frames a prompt; ``serve_lm.serve`` on an audio LM built by the
    caller with the same prompts and frames is its loop: the same ids and
    lines, and those ids the greedy loop over a cache of S + gen positions."""
    argv = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--opt",
            "--batch", "2", "--prompt-len", "10", "--gen", "3", "--seed", "5"]
    res = serve_lm.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={res.lm.cfg.name} batch=2 prompt=10 gen=3"
    cfg = configs.smoke(ARCH)
    frames = serve_lm.make_frontend(cfg, 2, 10, "cpu", 5)
    assert frames.shape == (2, 10, cfg.d_model) and frames.dtype == torch.bfloat16
    assert torch.equal(res.frontend, frames)
    built = lm.LM(cfg, q_block=10, perf=lm.OPTIMIZED, device="cpu", seed=5)
    prompts = serve_lm.make_prompts(cfg.vocab, 2, 10, "cpu", 5)
    again = serve_lm.serve(built, prompts, 3, frames)
    assert torch.equal(again.ids, res.ids) and again.ids.shape == (2, 4)
    assert capsys.readouterr().out.strip().splitlines()[2] == lines[2]
    cache, lg = built.prefill({"tokens": prompts, "frontend": frames}, max_len=13)
    ids = [lg[:, -1].argmax(-1)]
    for step in range(3):
        cache, lg = built.decode_step(cache, ids[-1], 10 + step)
        ids.append(lg.argmax(-1))
    assert torch.equal(torch.stack(ids, 1), res.ids)
