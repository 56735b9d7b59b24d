"""The port's LM served across ranks (``LM(cfg, mesh=...)``: tensor
parallelism over ``"model"``, the batch over ``"data"``, the cache's
positions over ``"model"``, the MoE's expert-parallel all-to-all) against
the reference's ``LM`` on the same ("data", "model") mesh, on the CPU.

The ranks are spawned once per mesh, (1, 2), (1, 4) and (2, 2) of gloo
ranks and one lone rank (tests/_torch_ranks.py ``run_tp_rank``), all at
once, while one JAX subprocess on 4 virtual devices runs the reference on
the same meshes.  The weights and tokens come from numpy seeds
(``tp_make_weights``: the port's per-layer leaves, which the reference's
side stacks; each side rounds them to its dtype), through one npz;
``vocab_padded`` is 256 on every mesh here.  The smoke configs of GLM-4-9B (dense) and Phi-3.5-MoE have 4 q
heads over 2 kv heads, so that at tp = 4 a rank holds one q head of a GQA
group of two.  Each mesh runs both archs at two of the four (dtype, flags)
pairs (``TP_FLAGS``), and Phi at a prompt no tp divides (S = 7: its prefill
takes the local expert path); (1, 4) and (2, 2) also run Phi with two
shared experts and one leading dense block (``TP_SHARED``).  Phi runs fp32 at its own capacity factor,
1.25, which drops assignments here; the drops depend on each rank's own N,
so that they differ from a (1, 1) run's and are held to the reference's at
the same mesh, shard by shard (a spy on the reference's
``_dispatch_shard`` reports each shard's count).

Limits: ``tests/test_torch_lm.py``'s ``TOL``, fp32 1e-5, bf16 3e-2 under
the baseline flags and 6e-2 under the optimized ones, for the prefill's
logits, the 3 teacher-forced decode steps' and each rank's cache slice
against the reference's cache at the same rows and positions (the padding
past M is zero); the MoE layer alone (tests/test_moe.py's (1, 4) cases) at
test_torch_moe.py's fp32 1e-5; the dropped counts, the collective counts
(``LM.collectives_per_call``, the formula of ``models/lm.py``'s docstring,
and this file's own count of it), the weights' slices and, at one rank,
the sharded LM against the mesh-less one, exactly.  The reference's bf16
optimized flags leave out ``bf16_attention`` and the port's keep it, as in
tests/test_torch_lm.py.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R
from repro_torch.configs import ARCH_NAMES

TESTS = Path(__file__).resolve().parent
TOL = {("float32", False): 1e-5, ("float32", True): 1e-5,
       ("bfloat16", False): 3e-2, ("bfloat16", True): 6e-2}
TOL_MOE = 1e-5

_REFERENCE = """
import dataclasses, json, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from jax import lax
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh, set_mesh
from repro.models import lm as rlm, moe as rmoe
from repro.models.config import MoEConfig
from repro.models.sharding import Axes
import _torch_ranks as R

weights = np.load({weights!r})
drops = []
orig = rmoe._dispatch_shard


def spy(p, x, *, top_k, n_experts, mlp_kind, ep_axis, capacity_factor):
    # each shard's assignments past its capacity, the dispatch's own count
    B, S, D = x.shape
    cap = max(int(np.ceil(B * S * top_k * capacity_factor / n_experts)), 1)
    _, idx, _, _ = rmoe.route(p["router"], x.reshape(B * S, D), top_k)
    counts = jnp.bincount(idx.reshape(-1), length=n_experts)
    jax.debug.callback(lambda a, b, n: drops.append((int(a), int(b), int(n))),
                       lax.axis_index("data"), lax.axis_index(ep_axis),
                       jnp.sum(jnp.maximum(counts - cap, 0)))
    return orig(p, x, top_k=top_k, n_experts=n_experts, mlp_kind=mlp_kind, ep_axis=ep_axis,
                capacity_factor=capacity_factor)


rmoe._dispatch_shard = spy


def tree(arch, abstract):
    # the reference's tree of the port's per-layer leaves, each group of
    # layers stacked on a leading axis, in the abstract tree's dtypes
    def leaf(path, a):
        names = [k.key for k in path]
        if names[0] in ("blocks", "dense0"):
            x = np.stack([weights[arch + ":" + ".".join([names[0], str(i), *names[1:]])]
                          for i in range(a.shape[0])])
        else:
            x = weights[arch + ":" + ".".join(names)]
        return jnp.asarray(x, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


res, info = {{}}, {{}}
for shape in R.TP_MESHES:
    mesh = make_mesh(shape, ("data", "model"))
    for arch, dtype, opt, S in R.tp_cases(shape):
        key = R.tp_key(arch, dtype, opt, S)
        flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
        if opt and dtype == "bfloat16":
            flags = dataclasses.replace(flags, bf16_attention=False)
        cfg = R.tp_config(rconfigs, arch, dtype)
        ref = rlm.LM(cfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=flags,
                     batch_sharded=R.TP_B % shape[0] == 0)
        params = tree(arch, ref.abstract_params())
        toks = R.tp_tokens(S).astype(np.int32)
        drops.clear()
        with set_mesh(mesh):
            cache, lg = jax.jit(lambda p, b: ref.prefill(p, b, max_len=S + 3))(
                params, {{"tokens": jnp.asarray(toks[:, :S])}})
            jax.block_until_ready(lg)
            prefill_drops = list(drops)
            out = [lg[:, 0]]
            decode = jax.jit(ref.decode_step)
            for t in range(3):
                cache, lg = decode(params, cache, jnp.asarray(toks[:, S + t]), jnp.int32(S + t))
                out.append(lg)
        tag = "x".join(map(str, shape)) + "|" + key
        res["lg|" + tag] = np.stack([np.asarray(a, np.float32) for a in out])
        for kv in ("k", "v"):
            res[kv + "|" + tag] = np.asarray(cache["blocks"][kv], np.float32)
        info["drops|" + tag] = prefill_drops

mesh = make_mesh((1, 4), ("data", "model"))
E, k, ff, D, B, S = R.TP_MOE_DIMS
p = {{n: jnp.asarray(weights["moe:" + n]) for n in ("router", "w_gate", "w_up", "w_down")}}
x = jnp.asarray(weights["moe:x"])
for path, cf in R.TP_MOE_CASES:
    cfg = MoEConfig(n_experts=E, top_k=k, d_ff_expert=ff, capacity_factor=cf)
    fn = rmoe.moe_apply_a2a if path == "a2a" else rmoe.moe_apply_local
    drops.clear()
    with set_mesh(mesh):
        y, _, _ = jax.jit(lambda p, x: fn(p, x, mesh, cfg=cfg, mlp_kind="swiglu",
                                          dp_axes=("data",), ep_axis="model"))(p, x)
        jax.block_until_ready(y)
    res["moe|" + path + "|" + str(cf)] = np.asarray(y)
    info["moe_drops|" + path + "|" + str(cf)] = list(drops)

np.savez({out!r}, **res)
open({info_out!r}, "w").write(json.dumps(info))
"""


def _mesh_tag(shape) -> str:
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(ranks, reference)``: by mesh tag, each rank's (arrays, info); the
    reference's arrays and info."""
    d = tmp_path_factory.mktemp("torch_tp")
    R.tp_make_weights(d / "weights.npz")
    meshes = {_mesh_tag(s): s for s in ((1, 1), *R.TP_MESHES)}
    joins = []
    for tag, shape in meshes.items():
        (d / tag).mkdir()
        joins.append(R.start(functools.partial(R.run_tp_rank, mesh_shape=shape), d / tag, world=shape[0] * shape[1]))
    out, info_out = d / "reference.npz", d / "reference.json"
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), weights=str(d / "weights.npz"),
                                  out=str(out), info_out=str(info_out)), ndev=4)
    finally:
        for join in joins:
            join(timeout=400)
    ranks = {tag: [(dict(np.load(d / tag / f"tp{r}.npz")),
                    json.loads((d / tag / f"tp{r}.json").read_text()))
                   for r in range(shape[0] * shape[1])]
             for tag, shape in meshes.items()}
    return ranks, (dict(np.load(out)), json.loads(info_out.read_text()))


CASES = [(shape, case) for shape in R.TP_MESHES for case in R.tp_cases(shape)]
CASE_IDS = [f"{_mesh_tag(s)}-{R.tp_key(*c).replace(':', '-')}" for s, c in CASES]


def _rows(shape, drank):
    """The reference's batch rows a data rank holds."""
    if shape[0] == 1 or R.TP_B % shape[0]:
        return slice(None)
    b = R.TP_B // shape[0]
    return slice(drank * b, (drank + 1) * b)


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_reference(runs, shape, case):
    """Every rank returns the whole batch's logits (the padded vocabulary),
    the prefill's and 3 teacher-forced decode steps', within ``TOL`` of the
    reference's at the same mesh."""
    ranks, (ref, _) = runs
    arch, dtype, opt, S = case
    key = R.tp_key(*case)
    want = ref[f"lg|{_mesh_tag(shape)}|{key}"]
    tol = TOL[(dtype, opt)]
    for arrays, _ in ranks[_mesh_tag(shape)]:
        got = arrays["lg:" + key]
        assert got.shape == want.shape == (4, R.TP_B, 256)
        for i, name in enumerate(("prefill", "decode0", "decode1", "decode2")):
            np.testing.assert_allclose(got[i], want[i], rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_cache_slices_match_reference(runs, shape, case):
    """Each rank's k and v hold its batch rows and its block of ceil(M / tp)
    positions (M = S + 3) of the reference's cache after the 3 decode steps,
    within ``TOL``; the block's padding past M is zero."""
    ranks, (ref, _) = runs
    arch, dtype, opt, S = case
    key, tol, M, tp = R.tp_key(*case), TOL[(dtype, case[2])], case[3] + 3, shape[1]
    m = -(-M // tp)
    for arrays, info in ranks[_mesh_tag(shape)]:
        drank, rank = info["coord"]
        lo, n = rank * m, max(0, min(M, (rank + 1) * m) - rank * m)
        for kv in ("k", "v"):
            want = ref[f"{kv}|{_mesh_tag(shape)}|{key}"][:, _rows(shape, drank)]
            got = arrays[f"{kv}:{key}"]
            if opt:  # head-major (L, B, Hkv, M, dh)
                want, pos_axis = want[:, :, :, lo:lo + n], 3
            else:
                want, pos_axis = want[:, :, lo:lo + n], 2
            assert got.shape[pos_axis] == m
            np.testing.assert_allclose(np.take(got, range(n), axis=pos_axis), want,
                                       rtol=tol, atol=tol, err_msg=f"{kv} rank {rank}")
            assert not np.take(got, range(n, m), axis=pos_axis).any()


PHI_CASES = [(s, c) for s, c in CASES if c[0].startswith("phi35_moe_42b")]


@pytest.mark.parametrize("shape,case", PHI_CASES,
                         ids=[i for i, (s, c) in zip(CASE_IDS, CASES)
                              if c[0].startswith("phi35_moe_42b")])
def test_dropped_counts_match_reference_per_shard(runs, shape, case):
    """Each rank's dropped assignments over the prefill equal the
    reference's shard at its (data, model) coordinate; the fp32 runs at
    capacity factor 1.25 do drop where the dispatch is expert-parallel."""
    ranks, (_, info) = runs
    key = R.tp_key(*case)
    want = {}
    for a, b, n in info[f"drops|{_mesh_tag(shape)}|{key}"]:
        want[(a, b)] = want.get((a, b), 0) + n
    got = {tuple(i["coord"]): i["cases"][key]["dropped"] for _, i in ranks[_mesh_tag(shape)]}
    expert_parallel = case[3] % shape[1] == 0
    assert got == {c: want.get(c, 0) for c in got}
    assert bool(want) == expert_parallel
    if case[1] == "float32" and expert_parallel:
        assert sum(got.values()) > 0


def _formula(arch, shape, S):
    """The collectives of a prefill of (TP_B, S) (a decode step where S is
    None) on ``shape``, counted from the schedule: L layers, L_e of them
    with experts, s shared experts' MLP beside them (``TP_LAYERS``)."""
    L, L_e, s = R.TP_LAYERS[arch]
    g = int(shape[0] > 1)  # TP_B = 2 splits over two data ranks
    # embed; every layer's FFN (an MLP, the local experts or the shared MLP)
    ffn = (L - L_e) + L_e + s * L_e
    if S is None:  # and a layer's q gather, max, sum, o and wo; the logits
        return {"all_reduce": 1 + 4 * L + ffn, "all_gather": L + 1 + g}
    if L_e and S % shape[1] == 0:  # wo; an expert layer's two all-to-alls and gather
        return {"all_reduce": 1 + L + ffn - L_e, "all_to_all": 2 * L_e,
                "all_gather": L_e + 1 + g}
    return {"all_reduce": 1 + L + ffn, "all_gather": 1 + g}


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_collective_counts_match_formula(runs, shape, case):
    """A prefill's and each decode step's collectives, by kind, equal
    ``LM.collectives_per_call`` (the docstring's formula) and this file's
    count of the schedule, on every rank."""
    ranks, _ = runs
    key, (arch, S) = R.tp_key(*case), (case[0], case[3])
    for _, info in ranks[_mesh_tag(shape)]:
        c = info["cases"][key]
        assert c["want"] == [_formula(arch, shape, S), _formula(arch, shape, None)]
        assert c["counts"] == [c["want"][0]] + [c["want"][1]] * 3


@pytest.mark.parametrize("shape", R.TP_MESHES, ids=_mesh_tag)
def test_expert_parallel_prefill_sends_the_dispatch_buffer(runs, shape):
    """Each expert layer of an expert-parallel prefill issues exactly two
    ``all_to_all_single`` on the model group, the first of which sends the
    dispatch buffer itself (its first E cap rows, a view): no pack copy."""
    ranks, _ = runs
    for _, info in ranks[_mesh_tag(shape)]:
        for key, c in info["cases"].items():
            arch, S = key.split(":")[0], int(key.split(":")[3])
            n_a2a = 2 * R.TP_LAYERS[arch][1] if S % shape[1] == 0 else 0
            assert len(c["sends"]) == n_a2a == c["counts"][0].get("all_to_all", 0), key
            assert c["sends"][0::2] == [True] * (n_a2a // 2), key


@pytest.mark.parametrize("path,cf", R.TP_MOE_CASES, ids=[f"{p}-{c}" for p, c in R.TP_MOE_CASES])
def test_moe_layer_matches_reference_on_1x4(runs, path, cf):
    """``moe_apply_a2a`` and ``moe_apply_local`` alone on the (1, 4) mesh,
    tests/test_moe.py's layer, within 1e-5 of the reference's on every
    rank; at capacity factor 1.0 the dispatch drops, as the reference's
    shards do, rank by rank."""
    ranks, (ref, info) = runs
    want = ref[f"moe|{path}|{cf}"]
    drops = {b: n for _, b, n in info[f"moe_drops|{path}|{cf}"]}
    for arrays, rinfo in ranks["1x4"]:
        np.testing.assert_allclose(arrays[f"moe:{path}:{cf}"], want, rtol=TOL_MOE, atol=TOL_MOE)
        assert rinfo[f"moe_dropped:{path}:{cf}"] == drops.get(rinfo["coord"][1], 0)
    if path == "a2a":
        assert sorted(drops) == [0, 1, 2, 3]
        assert (sum(drops.values()) > 0) == (cf < 2)


@pytest.mark.parametrize("shape", R.TP_MESHES, ids=_mesh_tag)
@pytest.mark.parametrize("arch", R.TP_LAYERS)
def test_sharded_weights_are_slices_of_tp1(runs, shape, arch):
    """``LM(cfg, mesh=...)`` draws every leaf whole and keeps its slice: bit
    for bit ``shard_params`` of the mesh-less LM's state dict from the same
    seed, and ``LM.sharded``'s."""
    ranks, _ = runs
    assert all(info["weights"][arch] for _, info in ranks[_mesh_tag(shape)])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_family_builds_on_a_mesh(runs, arch):
    """Every smoke config builds as ``LM(cfg, mesh=...)`` on (1, 4) and
    serves a prefill and a decode step there: finite logits, and each
    call's collectives by kind, on every rank, ``collectives_per_call``'s,
    which is non-empty (the reference's comparison of each family is here,
    in tests/test_torch_tp_attention.py and in tests/test_torch_tp_ssm.py)."""
    ranks, _ = runs
    for _, info in ranks["1x4"]:
        build = info["builds"][arch]
        assert build["finite"]
        assert all(build["want"]) and build["counts"] == build["want"]
        assert build["want"][0]["all_reduce"] >= 1 and build["want"][0]["all_gather"] >= 1


@pytest.mark.parametrize("arch", R.TP_LAYERS)
def test_world_one_is_the_meshless_lm_bit_for_bit(runs, arch):
    """At one rank ``LM.sharded`` holds the mesh-less LM's very tensors, and
    its prefill, 3 greedy decode steps (logits and ids) and cache are the
    mesh-less LM's bit for bit."""
    ranks, _ = runs
    (_, info), = ranks["1x1"]
    assert info["world1"][arch] == {"shares_tensors": True, "logits": True, "ids": True,
                                    "cache": True}


def test_world_one_moe_paths_are_bitwise(runs):
    """At one rank ``moe_apply_a2a`` is ``moe_apply_capacity`` and
    ``moe_apply_local`` with the shard is itself without it, bit for bit
    (bf16, capacity factor 1.0: with drops)."""
    ranks, _ = runs
    (_, info), = ranks["1x1"]
    assert info["world1"]["moe"] == {"a2a": True, "local": True}


def test_serve_lm_model_parallel(runs):
    """``serve_lm --model-parallel 2`` on the (2, 2) world: the mesh (2, 2),
    every rank the same ids, and rank 0 alone prints the reference's three
    lines."""
    ranks, _ = runs
    serves = [info["serve"] for _, info in ranks["2x2"]]
    assert all(s["mesh"] == [2, 2] and s["vocab_padded"] == 256 for s in serves)
    assert all(s["ids"] == serves[0]["ids"] for s in serves)
    ids = np.asarray(serves[0]["ids"])
    assert ids.shape == (2, 4) and ids.min() >= 0 and ids.max() < 256
    lines = serves[0]["lines"]
    assert len(lines) == 3 and lines[0] == "arch=phi3.5-moe-42b-a6.6b batch=2 prompt=8 gen=3"
    assert lines[2] == f"sample generated ids: {ids[0][:12].tolist()}"
    assert all(s["lines"] == [] for s in serves[1:])

