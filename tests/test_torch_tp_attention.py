"""The port's attention families served across ranks (``LM(cfg,
mesh=...)``): MLA's latent cache (DeepSeek-V2-Lite, MoE with MLA), the
VLM's frontend positions (LLaVA-NeXT-34B) and the audio encoder–decoder's
cross cache (SeamlessM4T-medium), each against the reference's ``LM`` on the
same ("data", "model") mesh, on the CPU.

As in tests/test_torch_tp.py, the ranks are spawned once per mesh, (1, 2),
(1, 4) and (2, 2) of gloo ranks and one lone rank (tests/_torch_ranks.py
``run_tpa_rank``), all at once, while one JAX subprocess on 4 virtual
devices runs the reference on the same meshes.  The weights, tokens and
frontends come from numpy seeds (``tpa_make_weights``, ``tp_tokens``,
``tpa_frontend``); ``vocab_padded`` is 256 on every mesh.  Each mesh runs
each arch once (``TPA_CASES``: each arch meets both dtypes and both flag
sets), and (1, 2) also LLaVA's GQA group of 7 (14 q heads over 2 kv heads,
``TPA_G7``).  The VLM puts F = 4 frontend rows before its 8 tokens (M = F +
S + 3 = 15 positions); the audio encoder takes Se = 6 frames, so that on
(1, 4) the cross cache's blocks are of 2 positions and rank 3 holds padding
alone.

Limits: ``tests/test_torch_lm.py``'s ``TOL``, fp32 1e-5, bf16 3e-2 under
the baseline flags and 6e-2 under the optimized ones, for the prefill's
logits, the 3 teacher-forced decode steps' and each rank's cache slice
against the reference's cache at the same rows and positions (the padding
is zero), and for MLA's expanded decode (``absorbed=False``, which gathers
the latent cache) against the mesh-less LM's expanded steps; the collective
counts (``LM.collectives_per_call`` and this file's own count of the
schedule), the weights' slices and, at one rank, the sharded LM against the
mesh-less one, exactly.  The reference's bf16 optimized flags leave out
``bf16_attention`` and the port's keep it, as in tests/test_torch_lm.py.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R

TESTS = Path(__file__).resolve().parent
TOL = {("float32", False): 1e-5, ("float32", True): 1e-5,
       ("bfloat16", False): 3e-2, ("bfloat16", True): 6e-2}

_REFERENCE = """
import dataclasses, sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh, set_mesh
from repro.models import lm as rlm
from repro.models.sharding import Axes
import _torch_ranks as R

weights = np.load({weights!r})
STACKED = ("blocks", "dense0", "enc_blocks", "dec_blocks")


def tree(arch, abstract):
    # the reference's tree of the port's per-layer leaves, each group of
    # layers stacked on a leading axis, in the abstract tree's dtypes
    def leaf(path, a):
        names = [k.key for k in path]
        if names[0] in STACKED:
            x = np.stack([weights[arch + ":" + ".".join([names[0], str(i), *names[1:]])]
                          for i in range(a.shape[0])])
        else:
            x = weights[arch + ":" + ".".join(names)]
        return jnp.asarray(x, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


res = {{}}
for shape, cases in R.TPA_CASES.items():
    mesh = make_mesh(shape, ("data", "model"))
    for arch, dtype, opt in cases:
        key = R.tpa_key(arch, dtype, opt)
        flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
        if opt and dtype == "bfloat16":
            flags = dataclasses.replace(flags, bf16_attention=False)
        cfg = R.tpa_config(rconfigs, arch, dtype)
        ref = rlm.LM(cfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1, perf=flags,
                     batch_sharded=R.TPA_B % shape[0] == 0)
        params = tree(arch, ref.abstract_params())
        toks = R.tp_tokens(R.TPA_S).astype(np.int32)
        F = R.tpa_front(arch)
        batch = {{"tokens": jnp.asarray(toks[:, :R.TPA_S])}}
        if R.tpa_frontend(arch) is not None:
            batch["frontend"] = jnp.asarray(R.tpa_frontend(arch))
        with set_mesh(mesh):
            cache, lg = jax.jit(lambda p, b: ref.prefill(p, b, max_len=F + R.TPA_S + 3))(
                params, batch)
            out = [lg[:, 0]]
            decode = jax.jit(ref.decode_step)
            for t in range(3):
                cache, lg = decode(params, cache, jnp.asarray(toks[:, R.TPA_S + t]),
                                   jnp.int32(F + R.TPA_S + t))
                out.append(lg)
        tag = "x".join(map(str, shape)) + "|" + key
        res["lg|" + tag] = np.stack([np.asarray(a, np.float32) for a in out])
        for path, leaf in R.tpa_leaves(cache).items():
            res[path + "|" + tag] = np.asarray(leaf, np.float32)

np.savez({out!r}, **res)
"""


def _mesh_tag(shape) -> str:
    return "x".join(map(str, shape))


@pytest.fixture(scope="module")
def runs(subproc, tmp_path_factory):
    """``(ranks, reference)``: by mesh tag, each rank's (arrays, info); the
    reference's arrays."""
    d = tmp_path_factory.mktemp("torch_tp_attention")
    R.tpa_make_weights(d / "weights.npz")
    meshes = {_mesh_tag(s): s for s in ((1, 1), *R.TPA_CASES)}
    joins = []
    for tag, shape in meshes.items():
        (d / tag).mkdir()
        joins.append(R.start(functools.partial(R.run_tpa_rank, mesh_shape=shape), d / tag,
                             world=shape[0] * shape[1]))
    out = d / "reference.npz"
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), weights=str(d / "weights.npz"),
                                  out=str(out)), ndev=4)
    finally:
        for join in joins:
            join(timeout=400)
    ranks = {tag: [(dict(np.load(d / tag / f"tpa{r}.npz")),
                    json.loads((d / tag / f"tpa{r}.json").read_text()))
                   for r in range(shape[0] * shape[1])]
             for tag, shape in meshes.items()}
    return ranks, dict(np.load(out))


CASES = [(shape, case) for shape, cases in R.TPA_CASES.items() for case in cases]
CASE_IDS = [f"{_mesh_tag(s)}-{R.tpa_key(*c).replace(':', '-')}" for s, c in CASES]
MLA_CASES = [(s, c) for s, c in CASES if c[0].startswith("deepseek")]


def _rows(shape, drank):
    """The reference's batch rows a data rank holds."""
    if shape[0] == 1 or R.TPA_B % shape[0]:
        return slice(None)
    b = R.TPA_B // shape[0]
    return slice(drank * b, (drank + 1) * b)


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_reference(runs, shape, case):
    """Every rank returns the whole batch's logits (the padded vocabulary),
    the prefill's and 3 teacher-forced decode steps', within ``TOL`` of the
    reference's at the same mesh."""
    ranks, ref = runs
    key = R.tpa_key(*case)
    want = ref[f"lg|{_mesh_tag(shape)}|{key}"]
    tol = TOL[case[1:]]
    for arrays, _ in ranks[_mesh_tag(shape)]:
        got = arrays["lg:" + key]
        assert got.shape == want.shape == (4, R.TPA_B, 256)
        assert np.isfinite(got).all()
        for i, name in enumerate(("prefill", "decode0", "decode1", "decode2")):
            np.testing.assert_allclose(got[i], want[i], rtol=tol, atol=tol, err_msg=name)


def _pos_axis(path: str, opt: bool) -> int:
    """The position axis of a cache leaf with its layer axis: (L, B, M, ...)
    or head-major (L, B, H, M, d); MLA's latents take no head axis."""
    return 3 if opt and path.split(".")[-1] in ("k", "v", "ck", "cv") else 2


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_cache_slices_match_reference(runs, shape, case):
    """Each rank's cache leaves (MLA's ``ckv``, ``krope`` of every layer
    group; the VLM's ``k``, ``v`` over F + S + 3 positions; the audio
    decoder's ``k``, ``v`` and its cross ``ck``, ``cv`` of Se frames) hold
    its batch rows and its block of ceil(M / tp) positions of the
    reference's after the 3 decode steps, within ``TOL``; the block's
    padding past M is zero."""
    ranks, ref = runs
    arch, dtype, opt = case
    key, tol, tag = R.tpa_key(*case), TOL[(dtype, opt)], _mesh_tag(shape)
    paths = sorted(p.split("|")[0] for p in ref if p.endswith("|" + tag + "|" + key)
                   and not p.startswith("lg|"))
    want_paths = {"deepseek": ["blocks.ckv", "blocks.krope", "dense0.ckv", "dense0.krope"],
                  "llava": ["blocks.k", "blocks.v"], "seamless": ["ck", "cv", "k", "v"]}
    assert paths == want_paths[arch.split("_")[0]]
    for arrays, info in ranks[tag]:
        drank, rank = info["coord"]
        for path in paths:
            whole = ref[f"{path}|{tag}|{key}"][:, _rows(shape, drank)]
            ax = _pos_axis(path, opt)
            M, got = whole.shape[ax], arrays[f"{path}:{key}"]
            m = -(-M // shape[1])
            lo, n = rank * m, max(0, min(M, (rank + 1) * m) - rank * m)
            assert got.shape[ax] == m, path
            np.testing.assert_allclose(np.take(got, range(n), axis=ax),
                                       np.take(whole, range(lo, lo + n), axis=ax),
                                       rtol=tol, atol=tol, err_msg=f"{path} rank {rank}")
            assert not np.take(got, range(n, m), axis=ax).any(), path


def test_audio_rank_of_padding_alone(runs):
    """On (1, 4) the 6 encoder frames lie in blocks of 2: rank 3's ``ck``,
    ``cv`` are padding alone (zero), and its logits, which its masked
    scores add nothing to, are finite and the other ranks'."""
    ranks, _ = runs
    key = next(R.tpa_key(*c) for c in R.TPA_CASES[(1, 4)] if c[0].startswith("seamless"))
    arrays, info = ranks["1x4"][3]
    assert info["coord"] == [0, 3]
    for leaf in ("ck", "cv"):
        assert arrays[f"{leaf}:{key}"].shape[2] == 2 and not arrays[f"{leaf}:{key}"].any()
    assert np.isfinite(arrays["lg:" + key]).all()
    np.testing.assert_array_equal(arrays["lg:" + key], ranks["1x4"][0][0]["lg:" + key])


def _formula(arch, shape, seq, absorbed=True):
    """The collectives of a prefill of (TPA_B, seq) positions (a decode
    step where seq is None) on ``shape``, counted from the schedule."""
    g = int(shape[0] > 1)  # TPA_B = 2 splits over two data ranks
    if arch.startswith("seamless"):  # 2 encoder and 2 decoder layers
        if seq is None:  # embed; a layer's self- and cross-attention 4 + 4, its MLP
            return {"all_reduce": 1 + 2 * 9, "all_gather": 2 * 2 + 1 + g}
        return {"all_reduce": 1 + 2 * 2 + 2 * 3, "all_gather": 1 + g}
    if arch.startswith("llava"):  # 2 dense layers
        if seq is None:
            return {"all_reduce": 1 + 2 * 5, "all_gather": 2 + 1 + g}
        return {"all_reduce": 1 + 2 * 2, "all_gather": 1 + g}
    # DeepSeek: a dense block, then 2 expert blocks with shared experts
    if seq is None:  # attention 4 (absorbed) or 1 (expanded) a layer; MLP;
        a = 4 if absorbed else 1  # an expert layer's experts and shared MLP
        return {"all_reduce": 1 + 3 * a + 1 + 2 * 2, "all_gather": 3 + 1 + g}
    if seq % shape[1] == 0:  # wo; the dense MLP; the shared MLPs; the all-to-alls
        return {"all_reduce": 1 + 3 + 1 + 2, "all_to_all": 4, "all_gather": 2 + 1 + g}
    return {"all_reduce": 1 + 3 + 1 + 2 * 2, "all_gather": 1 + g}


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_collective_counts_match_formula(runs, shape, case):
    """A prefill's and each decode step's collectives, by kind, equal
    ``LM.collectives_per_call`` (the formula of ``models/lm.py``'s
    docstring) and this file's count of the schedule, on every rank."""
    ranks, _ = runs
    arch = case[0]
    seq = R.tpa_front(arch) + R.TPA_S
    for _, info in ranks[_mesh_tag(shape)]:
        c = info["cases"][R.tpa_key(*case)]
        assert c["want"] == [_formula(arch, shape, seq), _formula(arch, shape, None)]
        assert c["counts"] == [c["want"][0]] + [c["want"][1]] * 3


@pytest.mark.parametrize("shape,case", MLA_CASES,
                         ids=[i for i, (s, c) in zip(CASE_IDS, CASES) if (s, c) in MLA_CASES])
def test_mla_expanded_decode_matches_meshless(runs, shape, case):
    """MLA's expanded decode (``absorbed=False``) at tp > 1 all-gathers the
    latent cache's positions (one gather a layer) and expands the rank's own
    heads: its 3 teacher-forced steps within ``TOL`` of the mesh-less LM's
    expanded steps, and its collectives the formula's."""
    ranks, _ = runs
    key, tol = R.tpa_key(*case), TOL[case[1:]]
    for arrays, info in ranks[_mesh_tag(shape)]:
        np.testing.assert_allclose(arrays["expanded:" + key], arrays["expanded_meshless:" + key],
                                   rtol=tol, atol=tol)
        c = info["cases"][key]
        want = _formula(case[0], shape, None, absorbed=False)
        assert c["expanded_want"] == want and c["expanded_counts"] == [want] * 3


@pytest.mark.parametrize("shape", list(R.TPA_CASES), ids=_mesh_tag)
@pytest.mark.parametrize("arch", R.TPA_ARCHS)
def test_sharded_weights_are_slices_of_tp1(runs, shape, arch):
    """``LM(cfg, mesh=...)`` draws every leaf whole and keeps its slice: bit
    for bit ``shard_params`` of the mesh-less LM's state dict from the same
    seed, and ``LM.sharded``'s (MLA's ``w_uk``, ``w_uv`` by head columns;
    the encoder's blocks and the decoder's ``cross`` by the attention's
    rules)."""
    ranks, _ = runs
    assert all(info["weights"][arch] for _, info in ranks[_mesh_tag(shape)])


@pytest.mark.parametrize("arch", R.TPA_ARCHS)
def test_world_one_is_the_meshless_lm_bit_for_bit(runs, arch):
    """At one rank ``LM.sharded`` holds the mesh-less LM's very tensors, and
    its prefill, 3 greedy decode steps (logits and ids), every cache leaf
    and, for MLA, the expanded decode step are the mesh-less LM's bit for
    bit; its collectives are ``LM.collectives_per_call``'s."""
    ranks, _ = runs
    (_, info), = ranks["1x1"]
    want = {"shares_tensors": True, "logits": True, "ids": True, "cache": True,
            "expanded": True if arch.startswith("deepseek") else None, "collectives": True}
    assert info["world1"][arch] == want


@pytest.mark.parametrize("arch", list(R.TPA_SERVE_ARGV))
def test_serve_lm_model_parallel(runs, arch):
    """``serve_lm --model-parallel 2`` on the (2, 2) world for the VLM and
    the audio arch: the mesh (2, 2), every rank the same ids, and rank 0
    alone prints the reference's three lines."""
    ranks, _ = runs
    serves = [info["serve"][arch] for _, info in ranks["2x2"]]
    assert all(s["mesh"] == [2, 2] for s in serves)
    assert all(s["ids"] == serves[0]["ids"] for s in serves)
    ids = np.asarray(serves[0]["ids"])
    assert ids.shape == (2, 4) and ids.min() >= 0 and ids.max() < 256
    lines = serves[0]["lines"]
    name = {"llava_next_34b": "llava-next-34b", "seamless_m4t_medium": "seamless-m4t-medium"}
    assert len(lines) == 3 and lines[0] == f"arch={name[arch]} batch=2 prompt=6 gen=3"
    assert lines[2] == f"sample generated ids: {ids[0][:12].tolist()}"
    assert all(s["lines"] == [] for s in serves[1:])
