"""The port's MoE family (``repro_torch.models.moe`` and the MoE ``LM``)
against the reference's, on the CPU.

Inputs come from numpy seeds; the reference's weights cross over through
``to_tensor`` and ``lm_params_from_reference``.  The reference's expert
paths run under ``shard_map`` on a (1, 1) mesh, where the expert-parallel
all-to-all and psum are the identity, as they are in the port.

Limits: the layer functions in fp32 within rtol = atol = 1e-5 (the two
agree to ~1e-7; summation order differs); expert ids and the dropped
assignments identical.  The LM: ``tests/test_torch_lm.py``'s limits, fp32
1e-5, bf16 3e-2 under the baseline flags and 6e-2 under the optimized
ones.  The smoke config's capacity factor (8.0) drops nothing, so a
prefill and the decode steps after it compute the same function, and
teacher-forced decode is held to a prefill of S + 3.

In bf16 each package rounds its activations in its own order, so that
the two drift apart as each drifts from an fp32 run of the same weights:
with two shared experts and a leading dense block (three layers), each
package's logits lie up to 3.2e-2 from that fp32 run at this seed (port
3.16e-2, reference 3.24e-2), and the two up to 3.9e-2 apart, across the
baseline limit of 3e-2; there the limit is 6e-2 under both flag sets.  One
router margin of 2.6e-3 in that run also lands on different sides in the
two packages (decode step 2 and the S + 3 prefill, layer 1).  That the
port's bf16 is as close to the fp32 run as the reference's is held by a
test of its own, within 1.25 x the reference's distance.  In fp32 every
expert id of every layer and step is the reference's.

The reference's CPU backend cannot run ``bf16_attention`` in bf16 (see
``tests/test_torch_lm.py``), so its optimized bf16 run leaves it out, and
here the port's does too: both packages run the same flags.  With it on,
the port's decode rounds p to bf16 before p . v and the reference's does
not, and at this seed that moves a router margin of 7e-4 (the second and
third of 8 probabilities, layer 1, decode step 1) across the tie: the
token's second expert changes and its logits leave the limit.  That is two
functions, not a fault; a dense layer has no such edge.
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
from repro.models import moe as rmoe
from repro.models.config import MoEConfig as RMoEConfig
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.kernels.flash import ops as flash_ops
from repro_torch.launch import serve_lm
from repro_torch.models import lm, moe
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import lm_params_from_reference, to_tensor

B, S, D = 2, 8, 12
TOL = {("float32", False): 1e-5, ("float32", True): 1e-5,
       ("bfloat16", False): 3e-2, ("bfloat16", True): 6e-2}
TOL_BF16_SHARED = 6e-2  # the shared_dense0 variant in bf16 (module docstring)
KINDS = ("swiglu", "geglu", "relu2", "gelu")
ARCH = "phi35_moe_42b"
# Phi-3.5-MoE's expert blocks, and DeepSeek's structure without MLA: two
# shared experts beside the routed ones and one leading dense block
VARIANTS = {"phi35": {}, "shared_dense0": {"n_shared": 2, "first_k_dense": 1}}


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 1), ("data", "model"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else to_tensor(v) for k, v in tree.items()}


def _layer(mesh, kind, n_shared, capacity_factor, seed=0, E=8, k=2, N=(B, S)):
    """(reference params, port params, x numpy (B, S, D), both configs)."""
    kw = dict(n_experts=E, top_k=k, n_shared=n_shared, d_ff_expert=16,
              capacity_factor=capacity_factor)
    rcfg, cfg = RMoEConfig(**kw), MoEConfig(**kw)
    p = _np(rmoe.moe_init(jax.random.PRNGKey(seed), D, rcfg, kind, jnp.float32))
    x = np.random.default_rng(seed + 1).standard_normal((*N, D)).astype(np.float32)
    return p, _torch(p), x, rcfg, cfg


def _ref_apply(mesh, fn, p, x, rcfg, kind):
    with set_mesh(mesh):
        y, aux, z = jax.jit(lambda p, x: fn(p, x, mesh, cfg=rcfg, mlp_kind=kind,
                                            dp_axes=("data",), ep_axis="model"))(p, x)
    return np.asarray(y), float(aux), float(z)


def _dropped(ids: np.ndarray, E: int, cap: int) -> int:
    """Assignments past capacity, counted the reference's way: each
    expert's assignments in flat token order, those from the cap-th on."""
    flat = ids.reshape(-1)
    return sum(max(0, int((flat == e).sum()) - cap) for e in range(E))


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,k", [(8, 2), (16, 2), (16, 6)])
def test_route_matches_reference(E, k):
    rng = np.random.default_rng(E * k)
    w = rng.standard_normal((D, E)).astype(np.float32)
    x = rng.standard_normal((64, D)).astype(np.float32)
    want = [np.asarray(a) for a in rmoe.route(jnp.asarray(w), jnp.asarray(x), k)]
    got = [a.numpy() for a in moe.route(torch.from_numpy(w), torch.from_numpy(x), k)]
    np.testing.assert_array_equal(got[1], want[1])
    for g, wt, name in zip(got, want, ("gates", "ids", "aux", "zloss")):
        np.testing.assert_allclose(g, wt, rtol=1e-5, atol=1e-6, err_msg=name)


def test_route_breaks_ties_by_index():
    """Equal probabilities (a zero router): the lower expert ids first, as
    ``lax.top_k`` orders them."""
    w = np.zeros((D, 8), np.float32)
    x = np.random.default_rng(0).standard_normal((5, D)).astype(np.float32)
    want = np.asarray(rmoe.route(jnp.asarray(w), jnp.asarray(x), 3)[1])
    got = moe.route(torch.from_numpy(w), torch.from_numpy(x), 3)[1].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tile([0, 1, 2], (5, 1)))


@pytest.mark.parametrize("n_shared", [0, 2])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.1])
def test_capacity_dispatch_matches_reference(mesh, capacity_factor, kind, n_shared):
    """``moe_apply_capacity`` against ``moe_apply_a2a``: at 8.0 nothing is
    dropped; at 0.1 (cap = 1) most assignments are, the same ones."""
    p, tp, x, rcfg, cfg = _layer(mesh, kind, n_shared, capacity_factor)
    want, aux, z = _ref_apply(mesh, rmoe.moe_apply_a2a, p, x, rcfg, kind)
    moe.assignments.clear()
    got, taux, tz = moe.moe_apply_capacity(tp, torch.from_numpy(x), cfg=cfg, mlp_kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(taux), float(tz)], [aux, z], rtol=1e-5)
    ids = np.asarray(rmoe.route(jnp.asarray(p["router"]), jnp.asarray(x.reshape(-1, D)),
                                cfg.top_k)[1])
    cap = max(1, int(np.ceil(B * S * cfg.top_k * capacity_factor / cfg.n_experts)))
    dropped = int(moe.assignments["dropped"])
    assert moe.assignments["routed"] == B * S * cfg.top_k
    assert dropped == _dropped(ids, cfg.n_experts, cap)
    assert (dropped > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("path", ["local", "dense"])
def test_all_expert_paths_match_reference(mesh, path, kind):
    p, tp, x, rcfg, cfg = _layer(mesh, kind, 2, 1.25, seed=5, E=16, k=4)
    if path == "local":
        want, aux, z = _ref_apply(mesh, rmoe.moe_apply_local, p, x, rcfg, kind)
        fn = moe.moe_apply_local
    else:
        y, aux, z = rmoe.moe_apply_dense(p, jnp.asarray(x), cfg=rcfg, mlp_kind=kind)
        want, aux, z = np.asarray(y), float(aux), float(z)
        fn = moe.moe_apply_dense
    got, taux, tz = fn(tp, torch.from_numpy(x), cfg=cfg, mlp_kind=kind)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(taux), float(tz)], [aux, z], rtol=1e-5)


def test_capacity_dispatch_without_drops_is_the_all_expert_path():
    """Where nothing is dropped, the dispatch and the decode path compute
    one function (the LM's prefill and decode steps agree)."""
    _, tp, x, _, cfg = _layer(None, "swiglu", 0, 8.0, seed=2)
    xt = torch.from_numpy(x)
    a = moe.moe_apply_capacity(tp, xt, cfg=cfg, mlp_kind="swiglu")[0]
    b = moe.moe_apply_local(tp, xt, cfg=cfg, mlp_kind="swiglu")[0]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_moe_init_shapes_and_dtypes():
    cfg = MoEConfig(n_experts=4, top_k=2, n_shared=2, d_ff_expert=8)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 16, cfg, "swiglu", torch.bfloat16)
    assert p["router"].dtype == torch.float32 and p["router"].shape == (16, 4)
    assert p["w_gate"].shape == p["w_up"].shape == (4, 16, 8)
    assert p["w_down"].shape == (4, 8, 16) and p["w_down"].dtype == torch.bfloat16
    assert p["shared"]["w_up"].shape == (16, 16)
    # each expert's matrix its own draw
    assert not torch.equal(p["w_up"][0], p["w_up"][1])
    assert "w_gate" not in moe.moe_init(gen, 16, cfg, "relu2", torch.bfloat16)


# ---------------------------------------------------------------------------
# The LM
# ---------------------------------------------------------------------------


def _configs(variant, dtype):
    """(reference config, port config) of Phi-3.5-MoE's smoke config."""
    out = []
    for c in (rconfigs.smoke(ARCH), configs.smoke(ARCH)):
        kw = VARIANTS[variant]
        if kw:
            c = dataclasses.replace(c, n_layers=c.n_layers + kw["first_k_dense"],
                                    moe=dataclasses.replace(c.moe, **kw))
        out.append(dataclasses.replace(c, dtype=dtype))
    return out


def _pair(mesh, variant, dtype, opt, seed=3):
    """(reference LM, its params, port LM holding the same weights)."""
    ref_flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
    if opt and dtype == "bfloat16":
        ref_flags = dataclasses.replace(ref_flags, bf16_attention=False)
    rcfg, cfg = _configs(variant, dtype)
    ref = rlm.LM(rcfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=ref_flags)
    with set_mesh(mesh):
        params = ref.init_params(jax.random.PRNGKey(seed))
    port = lm.LM(cfg, q_block=4, perf=lm.PerfFlags(**dataclasses.asdict(ref_flags)),
                 device="cpu")
    port.load_state_dict(lm_params_from_reference(cfg, _np(params)), strict=True)
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


def _routed_ids(monkeypatch):
    """Lists that collect the expert ids of every ``route`` call, the
    reference's (through a host callback) and the port's."""
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
    return ref_ids, port_ids


def _toks(port):
    return np.random.default_rng(11).integers(0, port.cfg.vocab, (B, S + 3)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", [False, True], ids=["baseline", "optimized"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_reference(mesh, monkeypatch, variant, opt, dtype):
    ref, params, port = _pair(mesh, variant, dtype, opt)
    toks = _toks(port)
    ref_ids, port_ids = _routed_ids(monkeypatch)
    want = _serve_ref(mesh, ref, params, toks)
    moe.assignments.clear()
    got = _serve_port(port, toks)
    assert int(moe.assignments["dropped"]) == 0  # the smoke capacity drops nothing
    # every expert block of 2 prefills and 3 decode steps routed once
    assert len(ref_ids) == len(port_ids) == 5 * len(port.blocks)
    if dtype == "float32":  # the callbacks' order is not promised: compare as multisets
        key = lambda a: (a.shape, a.astype(np.int64).tobytes())  # noqa: E731
        assert sorted(map(key, ref_ids)) == sorted(map(key, port_ids))
    tol = (TOL_BF16_SHARED if dtype == "bfloat16" and port.cfg.moe.n_shared
           else TOL[(dtype, opt)])
    for name, g, w in zip(("prefill", "decode0", "decode1", "decode2", "prefill_full"),
                          got, want):
        assert g.shape == (B, port.vocab_padded), name
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=name)
    # teacher-forced decode reproduces the longer prefill, in the port alone
    np.testing.assert_allclose(got[3], got[4], rtol=tol, atol=tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_error_is_the_references(mesh, variant):
    """The port's bf16 logits lie no farther from an fp32 run of the same
    (bf16-valued) weights than 1.25 x the reference's bf16 logits do."""
    ref, params, port = _pair(mesh, variant, "bfloat16", False)
    toks = _toks(port)
    want = _serve_ref(mesh, ref, params, toks)
    got = _serve_port(port, toks)
    twin = lm.LM(dataclasses.replace(port.cfg, dtype="float32"), q_block=4, device="cpu")
    twin.load_state_dict({k: v.float() for k, v in port.state_dict().items()}, strict=True)
    fp32 = _serve_port(twin, toks)
    port_err = max(float(np.abs(g - f).max()) for g, f in zip(got, fp32))
    ref_err = max(float(np.abs(w - f).max()) for w, f in zip(want, fp32))
    assert port_err <= 1.25 * ref_err, (port_err, ref_err)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converter_carries_every_weight_bit_for_bit(mesh, variant):
    _, params, port = _pair(mesh, variant, "bfloat16", True)
    sd = port.state_dict()
    assert set(sd) == set(lm_params_from_reference(port.cfg, _np(params)))
    n_dense = port.cfg.moe.first_k_dense
    assert (len(port.dense0), len(port.blocks)) == (n_dense, port.cfg.n_layers - n_dense)
    router = sd["blocks.1.moe.router"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(router.numpy(), np.asarray(params["blocks"]["moe"]["router"][1]))
    names = ["blocks.1.moe.w_gate", "blocks.0.moe.w_down"]
    trees = [params["blocks"]["moe"]["w_gate"][1], params["blocks"]["moe"]["w_down"][0]]
    if n_dense:
        names += ["dense0.0.mlp.w_up", "blocks.0.moe.shared.w_down"]
        trees += [params["dense0"]["mlp"]["w_up"][0], params["blocks"]["moe"]["shared"]["w_down"][0]]
        assert sd["dense0.0.mlp.w_up"].shape == (port.cfg.d_model, port.cfg.moe.dense_ff)
    for name, want in zip(names, trees):
        got = sd[name]
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16), err_msg=name)


@pytest.mark.parametrize("arch", [a for a in configs.ARCH_NAMES
                                  if configs.get(a).family == "moe"])
def test_moe_smoke_configs_serve(arch):
    """Every MoE config serves from seeded weights: finite logits of the
    right shape, one cache entry per layer group with the keys of its
    attention (GQA's k and v, MLA's latents), and the K6 wrapper's CPU path
    counts no launch."""
    cfg = configs.smoke(arch)
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (B, S)))
    before = sum(flash_ops.launches.values())
    cache, lg = port.prefill({"tokens": toks}, max_len=S + 1)
    n_dense = cfg.moe.first_k_dense
    assert set(cache) == ({"dense0", "blocks"} if n_dense else {"blocks"})
    n = cfg.n_layers - n_dense
    if cfg.mla is None:
        assert {k: tuple(v.shape) for k, v in cache["blocks"].items()} == {
            kv: (n, B, cfg.n_kv_heads, S + 1, cfg.head_dim) for kv in ("k", "v")}
    else:
        assert {k: tuple(v.shape) for k, v in cache["blocks"].items()} == {
            "ckv": (n, B, S + 1, cfg.mla.kv_lora_rank),
            "krope": (n, B, S + 1, cfg.mla.qk_rope_dim)}
    _, lg2 = port.decode_step(cache, lg[:, 0].argmax(-1), S)
    assert lg.shape == (B, 1, cfg.vocab) and lg2.shape == (B, cfg.vocab)
    assert torch.isfinite(lg).all() and torch.isfinite(lg2).all()
    assert sum(flash_ops.launches.values()) == before


def test_leading_dense_blocks_have_their_own_cache():
    _, cfg = _configs("shared_dense0", "float32")
    port = lm.LM(cfg, q_block=4, device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    cache, _ = port.prefill({"tokens": toks}, max_len=S + 2)
    assert cache["dense0"]["k"].shape == (1, B, S + 2, cfg.n_kv_heads, cfg.head_dim)
    assert cache["blocks"]["v"].shape == (cfg.n_layers - 1, B, S + 2, cfg.n_kv_heads,
                                          cfg.head_dim)
    assert not hasattr(port.dense0[0], "moe") and hasattr(port.blocks[0], "moe")


def test_prefill_drops_past_capacity_and_repeats_bitwise():
    """At a capacity factor that drops, two prefills of the same prompts
    are bitwise equal and the counter sees the drops; the decode path never
    drops."""
    cfg = configs.smoke(ARCH)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    port = lm.LM(cfg, q_block=4, perf=lm.OPTIMIZED, device="cpu", seed=4)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (B, S)))
    moe.assignments.clear()
    c1, lg1 = port.prefill({"tokens": toks}, max_len=S + 1)
    dropped = int(moe.assignments["dropped"])
    assert moe.assignments["routed"] == cfg.n_layers * B * S * cfg.moe.top_k
    assert dropped > 0
    c2, lg2 = port.prefill({"tokens": toks}, max_len=S + 1)
    assert torch.equal(lg1, lg2) and torch.equal(c1["blocks"]["k"], c2["blocks"]["k"])
    port.decode_step(c1, lg1[:, 0].argmax(-1), S)
    assert int(moe.assignments["dropped"]) == 2 * dropped


def test_moe_lm_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(configs.smoke(ARCH))


def test_converter_carries_mla_weights(mesh):
    """DeepSeek-V2-Lite's smoke weights cross over whole: the state dict
    loads under ``strict=True``, ``kv_norm`` stays fp32 and the MLA leaves
    are the reference's bit for bit."""
    arch = "deepseek_v2_lite_16b"
    ref = rlm.LM(rconfigs.smoke(arch), mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1)
    with set_mesh(mesh):
        params = _np(ref.init_params(jax.random.PRNGKey(2)))
    cfg = configs.smoke(arch)
    port = lm.LM(cfg, q_block=4, device="cpu")
    sd = lm_params_from_reference(cfg, params)
    port.load_state_dict(sd, strict=True)
    got = port.state_dict()
    assert set(got) == set(sd)
    assert got["blocks.0.attn.kv_norm"].dtype == torch.float32
    for group, i in (("dense0", 0), ("blocks", 1)):
        for name in ("wq", "w_dkv", "w_uk", "w_uv", "wo", "kv_norm"):
            want = np.asarray(params[group]["attn"][name][i])
            t = got[f"{group}.{i}.attn.{name}"]
            assert tuple(t.shape) == want.shape, name
            if t.dtype == torch.bfloat16:
                t, want = t.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16)
            np.testing.assert_array_equal(np.asarray(t), want, err_msg=f"{group}.{name}")


def test_serve_takes_a_built_lm(capsys):
    """``serve_lm.serve`` on an LM built by the caller is ``main``'s loop:
    the same seed gives the same ids and lines."""
    argv = ["--arch", ARCH, "--preset", "smoke", "--device", "cpu", "--opt",
            "--batch", "2", "--prompt-len", "8", "--gen", "3", "--seed", "5"]
    res = serve_lm.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={res.lm.cfg.name} batch=2 prompt=8 gen=3"
    cfg = configs.smoke(ARCH)
    built = lm.LM(cfg, q_block=8, perf=lm.OPTIMIZED, device="cpu", seed=5)
    prompts = serve_lm.make_prompts(cfg.vocab, 2, 8, "cpu", 5)
    assert torch.equal(prompts, res.prompts)
    again = serve_lm.serve(built, prompts, 3)
    assert torch.equal(again.ids, res.ids) and again.ids.shape == (2, 4)
    assert capsys.readouterr().out.strip().splitlines()[2] == lines[2]
