"""The port's VLM family (LLaVA-NeXT: the dense stack with the vision
frontend's embeddings put before the tokens) against the reference's, on
the CPU.

The reference's ``init_params`` weights cross over through
``lm_params_from_reference``; prompts and frontend embeddings come from a
numpy seed.  Both packages run LLaVA-NeXT's smoke config (8 frontend
tokens) through a prefill of F + S positions, 3 teacher-forced decode steps
at F + S .. F + S + 2, and a prefill of F + S + 3; the reference on a (1, 1)
mesh, jitted.  Limits: the other LM files' ``TOL_LM``, fp32 1e-4 and bf16
6e-2 (the reference's serving tolerance under the optimized flags).  The
reference's CPU backend cannot contract bf16 operands into an fp32 result,
so for bf16 its optimized flags leave out ``bf16_attention``, as
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
from repro.models import lm as rlm
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import serve_lm
from repro_torch.models import lm
from repro_torch.models.config import param_count
from repro_torch.models.convert import lm_params_from_reference

ARCH = "llava_next_34b"
TOL_LM = {"float32": 1e-4, "bfloat16": 6e-2}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, S = 2, 8


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
    LLaVA-NeXT's smoke config."""
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
    """Token ids (B, S + 3) and bf16 frontend embeddings (B, F, D)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 3)).astype(np.int32)
    fe = rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, torch.from_numpy(fe).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_llava_lm_matches_reference(mesh, opt, dtype):
    """Prefill logits and every cache leaf (``blocks.k``, ``blocks.v`` over
    F + S + 3 positions, in the layout ``hmajor_cache`` sets), 3
    teacher-forced decode steps (logits and the cache after them), and a
    prefill of F + S + 3 positions."""
    ref, params, port = _pair(mesh, dtype, opt)
    cfg = port.cfg
    F = cfg.n_frontend_tokens
    M = F + S + 3
    toks, fe = _inputs(cfg)
    fe_j = jnp.asarray(fe.float().numpy()).astype(jnp.bfloat16)
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=M))
        decode = jax.jit(ref.decode_step)
        rcache, rlg = prefill(params, {"tokens": jnp.asarray(toks[:, :S]), "frontend": fe_j})
        want, want_cache = [rlg[:, 0]], [_np(rcache["blocks"])]
        for t in range(3):
            rcache, rlg = decode(params, rcache, jnp.asarray(toks[:, S + t]),
                                 jnp.int32(F + S + t))
            want.append(rlg)
        want_cache.append(_np(rcache["blocks"]))
        want.append(prefill(params, {"tokens": jnp.asarray(toks), "frontend": fe_j})[1][:, 0])

    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S], "frontend": fe}, max_len=M)
    kv = ((cfg.n_layers, B, cfg.n_kv_heads, M, cfg.head_dim) if opt
          else (cfg.n_layers, B, M, cfg.n_kv_heads, cfg.head_dim))
    assert set(cache) == {"blocks"}
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache["blocks"].items()} == {
        "k": (kv, TORCH[dtype]), "v": (kv, TORCH[dtype])}
    got, got_cache = [lg[:, 0]], [{k: v.clone() for k, v in cache["blocks"].items()}]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], F + S + i)
        got.append(lg)
    got_cache.append(cache["blocks"])
    got.append(port.prefill({"tokens": t, "frontend": fe})[1][:, 0])

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


def test_converter_takes_the_dense_path_bit_for_bit(mesh):
    """The VLM's parameters are the dense family's: ``blocks`` unstacked,
    the rest passed through, bf16 bit for bit under ``strict=True``; the
    smoke LM holds ``param_count`` parameters."""
    _, params, port = _pair(mesh, "bfloat16", True)
    cfg = port.cfg
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(cfg, params))
    assert {k.split(".")[0] for k in sd} == {"embed", "final_norm", "lm_head", "blocks"}
    assert len(port.blocks) == cfg.n_layers
    for i in range(cfg.n_layers):
        for name in ("wq", "wk", "wv", "wo"):
            want = params["blocks"]["attn"][name][i]
            np.testing.assert_array_equal(
                sd[f"blocks.{i}.attn.{name}"].view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy().view(np.uint16),
                                  params["embed"].view(np.uint16))
    assert sum(p.numel() for p in port.parameters()) == param_count(cfg)


def test_frontend_takes_the_first_positions():
    """The frontend's embeddings stand before the tokens: the cache's first
    F positions are theirs (a prefill of the frontend alone, zero tokens
    after it, writes the same keys there), the prompt's follow, the rest of
    ``max_len`` stays zero; another frontend changes the logits; a decode
    step at F + S writes there and one past the cache is refused; no K6
    launch on the CPU."""
    cfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32")
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    F = cfg.n_frontend_tokens
    toks, fe = _inputs(cfg, seed=2)
    t = torch.from_numpy(toks[:, :S]).long()
    before = sum(flash_ops.launches.values())
    cache, lg = port.prefill({"tokens": t, "frontend": fe}, max_len=F + S + 1)
    k = cache["blocks"]["k"]  # (L, B, Hkv, M, dh)
    alone, _ = port.prefill({"tokens": t[:, :0], "frontend": fe})
    torch.testing.assert_close(k[:, :, :, :F], alone["blocks"]["k"], rtol=1e-5, atol=1e-5)
    assert k[:, :, :, F:F + S].abs().sum() > 0 and not k[:, :, :, F + S].any()
    _, lg_other = port.prefill({"tokens": t, "frontend": torch.zeros_like(fe)})
    assert not torch.allclose(lg, lg_other)
    _, lg2 = port.decode_step(cache, lg[:, 0].argmax(-1), F + S)
    assert k[:, :, :, F + S].abs().sum() > 0
    assert lg.shape == (B, 1, cfg.vocab) and lg2.shape == (B, cfg.vocab)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
    with pytest.raises(ValueError, match="cur_len"):
        port.decode_step(cache, lg[:, 0].argmax(-1), F + S + 1)
    assert sum(flash_ops.launches.values()) == before


def test_vlm_lm_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(configs.smoke(ARCH))


def test_serve_sizes_the_cache_and_decodes_past_the_frontend(capsys):
    """``serve_lm.main`` serves LLaVA-NeXT's smoke config with a seeded
    frontend; ``serve_lm.serve`` on an LM built by the caller with the same
    prompts and frontend gives the same ids and lines; those ids are the
    greedy loop over a cache of F + S + gen positions with each step at
    F + S + step."""
    argv = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--opt",
            "--batch", "2", "--prompt-len", "12", "--gen", "3", "--seed", "5"]
    res = serve_lm.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={res.lm.cfg.name} batch=2 prompt=12 gen=3"
    # tok/s over B x S, the prompt's tokens, as the reference counts them
    assert lines[1].startswith(f"prefill: {res.prefill_s:.3f}s ({2 * 12 / res.prefill_s:.0f} tok/s)")
    cfg = configs.smoke(ARCH)
    F = cfg.n_frontend_tokens
    fe = serve_lm.make_frontend(cfg, 2, 12, "cpu", 5)
    assert fe.shape == (2, F, cfg.d_model) and fe.dtype == torch.bfloat16
    assert torch.equal(res.frontend, fe)
    built = lm.LM(cfg, q_block=12, perf=lm.OPTIMIZED, device="cpu", seed=5)
    prompts = serve_lm.make_prompts(cfg.vocab, 2, 12, "cpu", 5)
    again = serve_lm.serve(built, prompts, 3, fe)
    assert torch.equal(again.ids, res.ids) and again.ids.shape == (2, 4)
    assert capsys.readouterr().out.strip().splitlines()[2] == lines[2]
    cache, lg = built.prefill({"tokens": prompts, "frontend": fe}, max_len=F + 12 + 3)
    ids = [lg[:, -1].argmax(-1)]
    for step in range(3):
        cache, lg = built.decode_step(cache, ids[-1], F + 12 + step)
        ids.append(lg.argmax(-1))
    assert torch.equal(torch.stack(ids, 1), res.ids)
