"""The port's serving LM (dense family) against the reference's, on the CPU.

The reference's ``init_params`` weights cross over through
``lm_params_from_reference``; prompts come from a numpy seed.  Both packages
run GLM-4's smoke config through a prefill of S tokens and 3 teacher-forced
decode steps, and a prefill of S + 3 tokens.

Limits: fp32 rtol = atol = 1e-5 (the two agree to ~2e-6 in the logits,
which reach ~4; summation order and libm's cos/sin/exp are what differ).
bf16: the reference's own serving tolerances, 3e-2 under the baseline
flags and 6e-2 under the optimized ones (tests/test_models.py).  The
reference's CPU backend cannot contract bf16 operands into an fp32 result,
so for bf16 its optimized flags leave out ``bf16_attention`` (its own test
of those flags does the same); the port runs ``OPTIMIZED`` whole.
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
from repro_torch.models.convert import lm_params_from_reference, to_tensor

B, S = 2, 8
TOL = {("float32", False): 1e-5, ("float32", True): 1e-5,
       ("bfloat16", False): 3e-2, ("bfloat16", True): 6e-2}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _pair(mesh, arch, dtype, opt, seed=3):
    """(reference LM, its params, port LM holding the same weights)."""
    ref_flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
    if opt and dtype == "bfloat16":
        ref_flags = dataclasses.replace(ref_flags, bf16_attention=False)
    rcfg = dataclasses.replace(rconfigs.smoke(arch), dtype=dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=ref_flags)
    with set_mesh(mesh):
        params = ref.init_params(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(configs.smoke(arch), dtype=dtype)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED if opt else lm.PerfFlags(), device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, jax.tree.map(np.asarray, params)),
                         strict=True)
    return ref, params, port


def _serve_ref(mesh, ref, params, toks):
    """[prefill logits, 3 decode logits, full-prefill logits] of the reference."""
    M = S + 3
    with set_mesh(mesh):
        prefill = jax.jit(lambda p, b: ref.prefill(p, b, max_len=M))
        decode = jax.jit(ref.decode_step)
        cache, lg = prefill(params, {"tokens": jnp.asarray(toks[:, :S])})
        out = [lg[:, 0]]
        for t in range(3):
            cache, lg = decode(params, cache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
            out.append(lg)
        out.append(prefill(params, {"tokens": jnp.asarray(toks)})[1][:, 0])
    return [np.asarray(x, np.float32) for x in out]


def _serve_port(port, toks):
    M = S + 3
    t = torch.from_numpy(toks).long()
    cache, lg = port.prefill({"tokens": t[:, :S]}, max_len=M)
    out = [lg[:, 0]]
    for i in range(3):
        cache, lg = port.decode_step(cache, t[:, S + i], S + i)
        out.append(lg)
    out.append(port.prefill({"tokens": t})[1][:, 0])
    return [x.numpy() for x in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
def test_prefill_and_decode_match_reference(mesh, opt, dtype):
    ref, params, port = _pair(mesh, "glm4_9b", dtype, opt)
    toks = np.random.default_rng(11).integers(0, port.cfg.vocab, (B, S + 3)).astype(np.int32)
    want = _serve_ref(mesh, ref, params, toks)
    got = _serve_port(port, toks)
    tol = TOL[(dtype, opt)]
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, port.vocab_padded), name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    # teacher-forced decode reproduces the longer prefill, in the port alone
    np.testing.assert_allclose(got[3], got[4], rtol=tol, atol=tol)


def test_converter_carries_every_weight_bit_for_bit(mesh):
    ref, params, port = _pair(mesh, "glm4_9b", "bfloat16", True)
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(port.cfg, jax.tree.map(np.asarray, params)))
    assert len(port.blocks) == port.cfg.n_layers
    want = np.asarray(params["blocks"]["attn"]["wq"][1]).view(np.uint16)
    got = sd["blocks.1.attn.wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(sd["final_norm.w"].numpy(),
                                  np.asarray(params["final_norm"]["w"]))
    assert to_tensor(np.zeros(3, np.float32)).dtype == torch.float32


@pytest.mark.parametrize("arch", ["glm4_9b", "stablelm_12b", "nemotron_4_15b", "qwen2_72b"])
def test_dense_smoke_configs_serve(arch):
    """Every dense config (swiglu/relu2, rmsnorm/layernorm, qkv bias) serves
    from seeded weights: finite logits of the right shape, and the K6
    wrapper's CPU path counts no launch."""
    cfg = configs.smoke(arch)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    before = sum(flash_ops.launches.values())
    cache, lg = port.prefill({"tokens": toks}, max_len=S + 1)
    assert cache["blocks"]["k"].shape == (cfg.n_layers, B, cfg.n_kv_heads, S + 1, cfg.head_dim)
    _, lg2 = port.decode_step(cache, lg[:, 0].argmax(-1), S)
    assert lg.shape == (B, 1, cfg.vocab) and lg2.shape == (B, cfg.vocab)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
    assert sum(flash_ops.launches.values()) == before


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_family_serves_its_smoke_config(arch):
    """Every config of the registry builds its smoke LM on the CPU (nothing
    is refused: ``not_ported`` is None), and a prefill (with the frontend's
    embeddings or frames where the family takes them) and one decode step
    give finite logits of the right shapes."""
    cfg = configs.smoke(arch)
    assert lm.not_ported(cfg) is None
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    batch = {"tokens": toks}
    frontend = serve_lm.make_frontend(cfg, B, S, "cpu", 0)
    assert (frontend is None) == (cfg.family not in ("vlm", "audio"))
    if frontend is not None:
        batch["frontend"] = frontend
    off = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    cache, lg = port.prefill(batch, max_len=off + S + 1)
    _, lg2 = port.decode_step(cache, lg[:, 0].argmax(-1), off + S)
    assert lg.shape == (B, 1, cfg.vocab) and lg2.shape == (B, cfg.vocab)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()


def test_configs_are_the_references():
    for arch in configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(rconfigs.get(arch))
        assert dataclasses.asdict(configs.smoke(arch)) == dataclasses.asdict(rconfigs.smoke(arch))
        assert configs.cells(arch) == rconfigs.cells(arch)
    assert configs.SHAPES == rconfigs.SHAPES


def test_resolve_flags():
    assert serve_lm.resolve_flags(True, "") == lm.OPTIMIZED
    assert serve_lm.resolve_flags(False, "tri, hmaj") == lm.PerfFlags(
        exact_causal_prefill=True, hmajor_cache=True)
    assert serve_lm.resolve_flags(False, "") == lm.PerfFlags()
    with pytest.raises(KeyError):
        serve_lm.resolve_flags(False, "bogus")


def test_serve_lm_cpu(capsys):
    argv = ["--arch", "glm4_9b", "--preset", "smoke", "--device", "cpu", "--opt",
            "--batch", "3", "--prompt-len", "12", "--gen", "5", "--seed", "4"]
    res = serve_lm.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=glm4-9b batch=3 prompt=12 gen=5"
    assert lines[1].startswith("prefill: ") and "decode: " in lines[1]
    assert lines[2] == f"sample generated ids: {res.ids[0][:12].tolist()}"
    assert res.ids.shape == (3, 6) and res.prompts.shape == (3, 12)
    assert 0 <= int(res.ids.min()) and int(res.ids.max()) < 256
    assert res.prefill_s > 0 and res.decode_s > 0
    # the first generated id is the prefill's greedy pick
    _, lg = res.lm.prefill({"tokens": res.prompts})
    torch.testing.assert_close(res.ids[:, 0], lg[:, -1].argmax(-1))
    # same seed, same ids
    assert torch.equal(serve_lm.main(argv).ids, res.ids)
