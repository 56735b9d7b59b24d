"""The port's SSM and hybrid families served across ranks (``LM(cfg,
mesh=...)``): Mamba1's channels (Falcon-Mamba-7B) and Mamba2's heads with
the shared attention+MLP block (Zamba2-2.7B), each against the reference's
``LM`` on the same ("data", "model") mesh, on the CPU.

As in tests/test_torch_tp_attention.py, the ranks are spawned once per mesh,
(1, 2), (1, 4) and (2, 2) of gloo ranks and one lone rank
(tests/_torch_ranks.py ``run_tps_rank``), all at once, while one JAX
subprocess on 4 virtual devices runs the reference on the same meshes.  The
weights are a seeded mesh-less port LM's in fp32 with its constant leaves
made to vary (``tps_make_weights``), the tokens numpy-seeded
(``tp_tokens``); the reference's side stacks the layers (the hybrid's on
two axes, groups and layers a group).  Each mesh runs both archs
(``TPS_CASES``: each arch meets both dtypes and both flag sets, each mesh
both dtypes) at B = 2, S = 20: longer than the smoke scan chunk of 16, so
that the prefill runs a padded second chunk.  At tp = 4 Falcon-Mamba's
smoke config holds 32 channels a rank, Zamba2's 4 SSD heads and 1 attention
head a rank.

Limits: tests/test_torch_ssm.py's ``TOL_LM``, fp32 1e-4 and bf16 6e-2, for
the prefill's logits and the 3 teacher-forced decode steps', each rank's
``ssm`` state slice against the reference's at the same rows and channels
or heads, the assembled ``conv`` state against the reference's whole one
(Mamba2's holds the rank's x channels beside B and C whole, so its slices
are not the reference's contiguous blocks) and the hybrid's ``k``, ``v``
slices at their positions (the padding is zero); Mamba2's B and C columns
of the ``conv`` state, the collective counts (``LM.collectives_per_call``
and this file's own count of the schedule), the weights' slices and, at one
rank, the sharded LM against the mesh-less one, exactly.
"""

import functools
import json
from pathlib import Path

import numpy as np
import pytest

import _torch_ranks as R
from repro_torch import configs

TESTS = Path(__file__).resolve().parent
TOL = {"float32": 1e-4, "bfloat16": 6e-2}

_REFERENCE = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh, set_mesh
from repro.models import lm as rlm
from repro.models.sharding import Axes
import _torch_ranks as R

weights = np.load({weights!r})


def tree(arch, cfg, abstract):
    # the reference's tree of the port's per-layer leaves: the SSM's blocks
    # stacked on one leading axis, the hybrid's on two (groups, layers a
    # group); its shared block passes through; in the abstract tree's dtypes
    lead = 2 if cfg.family == "hybrid" else 1
    def leaf(path, a):
        names = [k.key for k in path]
        if names[0] == "blocks":
            idx = np.ndindex(*a.shape[:lead])
            x = np.stack([weights[arch + ":" + ".".join(["blocks", *map(str, i), *names[1:]])]
                          for i in idx]).reshape(a.shape)
        else:
            x = weights[arch + ":" + ".".join(names)]
        return jnp.asarray(x, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


res = {{}}
for shape, cases in R.TPS_CASES.items():
    mesh = make_mesh(shape, ("data", "model"))
    for arch, dtype, opt in cases:
        key = R.tpa_key(arch, dtype, opt)
        cfg = R.tps_config(rconfigs, arch, dtype)
        ref = rlm.LM(cfg, mesh, Axes(multi_pod=False), q_block=4, xent_chunks=1,
                     perf=rlm.OPTIMIZED if opt else rlm.PerfFlags(),
                     batch_sharded=R.TPS_B % shape[0] == 0)
        params = tree(arch, cfg, ref.abstract_params())
        toks = R.tp_tokens(R.TPS_S).astype(np.int32)
        with set_mesh(mesh):
            cache, lg = jax.jit(lambda p, b: ref.prefill(p, b, max_len=R.TPS_S + 3))(
                params, {{"tokens": jnp.asarray(toks[:, :R.TPS_S])}})
            out = [lg[:, 0]]
            decode = jax.jit(ref.decode_step)
            for t in range(3):
                cache, lg = decode(params, cache, jnp.asarray(toks[:, R.TPS_S + t]),
                                   jnp.int32(R.TPS_S + t))
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
    d = tmp_path_factory.mktemp("torch_tp_ssm")
    R.tps_make_weights(d / "weights.npz")
    meshes = {_mesh_tag(s): s for s in ((1, 1), *R.TPS_CASES)}
    joins = []
    for tag, shape in meshes.items():
        (d / tag).mkdir()
        joins.append(R.start(functools.partial(R.run_tps_rank, mesh_shape=shape), d / tag,
                             world=shape[0] * shape[1]))
    out = d / "reference.npz"
    try:
        subproc(_REFERENCE.format(tests=str(TESTS), weights=str(d / "weights.npz"),
                                  out=str(out)), ndev=4)
    finally:
        for join in joins:
            join(timeout=400)
    ranks = {tag: [(dict(np.load(d / tag / f"tps{r}.npz")),
                    json.loads((d / tag / f"tps{r}.json").read_text()))
                   for r in range(shape[0] * shape[1])]
             for tag, shape in meshes.items()}
    return ranks, dict(np.load(out))


CASES = [(shape, case) for shape, cases in R.TPS_CASES.items() for case in cases]
CASE_IDS = [f"{_mesh_tag(s)}-{R.tpa_key(*c).replace(':', '-')}" for s, c in CASES]
HYBRID_CASES = [(s, c) for s, c in CASES if c[0].startswith("zamba2")]
HYBRID_IDS = [i for i, (s, c) in zip(CASE_IDS, CASES) if c[0].startswith("zamba2")]


def _rows(shape, drank):
    """The reference's batch rows a data rank holds."""
    if shape[0] == 1 or R.TPS_B % shape[0]:
        return slice(None)
    b = R.TPS_B // shape[0]
    return slice(drank * b, (drank + 1) * b)


def _groups(ranks):
    """The ranks' (arrays, info) by data rank, each group in model order."""
    out = {}
    for arrays, info in ranks:
        out.setdefault(info["coord"][0], []).append((info["coord"][1], arrays))
    return {dr: [a for _, a in sorted(g, key=lambda x: x[0])] for dr, g in out.items()}


def _close(got, want, tol, msg):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_prefill_and_decode_match_reference(runs, shape, case):
    """Every rank returns the whole batch's logits (the padded vocabulary),
    the prefill's and 3 teacher-forced decode steps', within ``TOL`` of the
    reference's at the same mesh."""
    ranks, ref = runs
    key = R.tpa_key(*case)
    want = ref[f"lg|{_mesh_tag(shape)}|{key}"]
    for arrays, _ in ranks[_mesh_tag(shape)]:
        got = arrays["lg:" + key]
        assert got.shape == want.shape == (4, R.TPS_B, 256)
        assert np.isfinite(got).all()
        for i, name in enumerate(("prefill", "decode0", "decode1", "decode2")):
            _close(got[i], want[i], TOL[case[1]], name)


def _state_paths(arch):
    return ("states.ssm", "states.conv") if arch.startswith("zamba2") else ("ssm", "conv")


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_ssm_state_slices_match_reference(runs, shape, case):
    """Each rank's ``ssm`` state after the 3 decode steps holds its batch
    rows and its block of channels (Mamba1: (L, B, Di / tp, N)) or heads
    (Mamba2: (G, J, B, H / tp, P, N)) of the reference's, within ``TOL``."""
    ranks, ref = runs
    arch, dtype, _ = case
    key, tag = R.tpa_key(*case), _mesh_tag(shape)
    path = _state_paths(arch)[0]
    whole = ref[f"{path}|{tag}|{key}"]
    ax = 3 if arch.startswith("zamba2") else 2  # channels / heads, after (lead..., B)
    for arrays, info in ranks[tag]:
        drank, rank = info["coord"]
        got = arrays[f"{path}:{key}"]
        n = whole.shape[ax] // shape[1]
        assert got.shape[ax] == n
        want = np.take(whole, range(rank * n, (rank + 1) * n), axis=ax)[
            (slice(None),) * (ax - 1) + (_rows(shape, drank),)]
        _close(got, want, TOL[dtype], f"{path} rank {rank}")


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_assembled_conv_state_matches_reference(runs, shape, case):
    """The ``conv`` state after the 3 decode steps, assembled over a data
    rank's model group, is the reference's whole state at its rows within
    ``TOL``: Mamba1's channel blocks concatenated; Mamba2's x channels
    concatenated over the ranks beside B and C, which every rank holds
    whole and bit for bit alike."""
    ranks, ref = runs
    arch, dtype, _ = case
    key, tag = R.tpa_key(*case), _mesh_tag(shape)
    path = _state_paths(arch)[1]
    whole = ref[f"{path}|{tag}|{key}"]
    lead = 2 if arch.startswith("zamba2") else 1
    for drank, group in _groups(ranks[tag]).items():
        parts = [a[f"{path}:{key}"] for a in group]
        if arch.startswith("zamba2"):
            two_n = 2 * configs.smoke(arch).ssm.d_state  # B and C
            for p in parts[1:]:
                np.testing.assert_array_equal(p[..., -two_n:], parts[0][..., -two_n:])
            got = np.concatenate([p[..., :-two_n] for p in parts] + [parts[0][..., -two_n:]], -1)
        else:
            got = np.concatenate(parts, -1)
        want = whole[(slice(None),) * lead + (_rows(shape, drank),)]
        assert got.shape == want.shape
        _close(got, want, TOL[dtype], f"{path} data rank {drank}")


def _pos_axis(opt: bool) -> int:
    """The position axis of the hybrid's ``k``, ``v``: (G, B, M, H, d) or
    head-major (G, B, H, M, d)."""
    return 3 if opt else 2


@pytest.mark.parametrize("shape,case", HYBRID_CASES, ids=HYBRID_IDS)
def test_hybrid_kv_slices_match_reference(runs, shape, case):
    """Each rank's shared-block ``k``, ``v`` (one a group) hold its batch
    rows and its block of ceil(M / tp) of the reference's S + 3 positions
    after the 3 decode steps, within ``TOL``; the block's padding past M is
    zero."""
    ranks, ref = runs
    arch, dtype, opt = case
    key, tag = R.tpa_key(*case), _mesh_tag(shape)
    for arrays, info in ranks[tag]:
        drank, rank = info["coord"]
        for path in ("k", "v"):
            whole = ref[f"{path}|{tag}|{key}"][:, _rows(shape, drank)]
            ax = _pos_axis(opt)
            M, got = whole.shape[ax], arrays[f"{path}:{key}"]
            m = -(-M // shape[1])
            lo, n = rank * m, max(0, min(M, (rank + 1) * m) - rank * m)
            assert got.shape[ax] == m, path
            _close(np.take(got, range(n), axis=ax), np.take(whole, range(lo, lo + n), axis=ax),
                   TOL[dtype], f"{path} rank {rank}")
            assert not np.take(got, range(n, m), axis=ax).any(), path


def _formula(arch, shape, seq):
    """The collectives of a prefill of (TPS_B, seq) positions (a decode
    step where seq is None) on ``shape``, counted from the schedule."""
    g = int(shape[0] > 1)  # TPS_B = 2 splits over two data ranks
    if arch.startswith("falcon"):  # the embedding; 2 Mamba1 layers: x_proj, out_proj
        return {"all_reduce": 1 + 2 * 2, "all_gather": 1 + g}
    # Zamba2: 2 groups of 2 Mamba2 layers (the norm's sum, out_proj), the
    # shared block once a group: prefill wo and MLP; a decode step's
    # attention 4 all-reduces and 1 all-gather, its MLP 1
    if seq is None:
        return {"all_reduce": 1 + 2 * 5 + 4 * 2, "all_gather": 2 + 1 + g}
    return {"all_reduce": 1 + 2 * 2 + 4 * 2, "all_gather": 1 + g}


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_collective_counts_match_formula(runs, shape, case):
    """A prefill's and each decode step's collectives, by kind, equal
    ``LM.collectives_per_call`` (the formula of ``models/lm.py``'s
    docstring) and this file's count of the schedule, on every rank."""
    ranks, _ = runs
    arch = case[0]
    for _, info in ranks[_mesh_tag(shape)]:
        c = info["cases"][R.tpa_key(*case)]
        assert c["want"] == [_formula(arch, shape, R.TPS_S), _formula(arch, shape, None)]
        assert c["counts"] == [c["want"][0]] + [c["want"][1]] * 3


@pytest.mark.parametrize("shape", list(R.TPS_CASES), ids=_mesh_tag)
@pytest.mark.parametrize("arch", R.TPS_ARCHS)
def test_sharded_weights_are_slices_of_tp1(runs, shape, arch):
    """``LM(cfg, mesh=...)`` draws every leaf whole and keeps its slice: bit
    for bit ``shard_params`` of the mesh-less LM's state dict from the same
    seed, and ``LM.sharded``'s (Mamba2's ``in_proj`` and ``conv_w`` cut
    part by part, the shared block by the attention's and the MLP's rules,
    ``w_in`` whole)."""
    ranks, _ = runs
    assert all(info["weights"][arch] for _, info in ranks[_mesh_tag(shape)])


@pytest.mark.parametrize("arch", R.TPS_ARCHS)
def test_world_one_is_the_meshless_lm_bit_for_bit(runs, arch):
    """At one rank ``LM.sharded`` holds the mesh-less LM's very tensors, and
    its prefill and 3 greedy decode steps (logits, ids) and every cache leaf
    are the mesh-less LM's bit for bit; its collectives are
    ``LM.collectives_per_call``'s."""
    ranks, _ = runs
    (_, info), = ranks["1x1"]
    assert info["world1"][arch] == {"shares_tensors": True, "logits": True, "ids": True,
                                    "cache": True, "collectives": True}


@pytest.mark.parametrize("arch", R.TPS_ARCHS)
def test_serve_lm_model_parallel(runs, arch):
    """``serve_lm --model-parallel 2`` on the (2, 2) world for both archs:
    the mesh (2, 2), every rank the same ids, and rank 0 alone prints the
    reference's three lines."""
    ranks, _ = runs
    serves = [info["serve"][arch] for _, info in ranks["2x2"]]
    assert all(s["mesh"] == [2, 2] for s in serves)
    assert all(s["ids"] == serves[0]["ids"] for s in serves)
    ids = np.asarray(serves[0]["ids"])
    assert ids.shape == (2, 4) and ids.min() >= 0 and ids.max() < 256
    lines = serves[0]["lines"]
    name = {"falcon_mamba_7b": "falcon-mamba-7b", "zamba2_2p7b": "zamba2-2.7b"}
    assert len(lines) == 3 and lines[0] == f"arch={name[arch]} batch=2 prompt=6 gen=3"
    assert lines[2] == f"sample generated ids: {ids[0][:12].tolist()}"
    assert all(s["lines"] == [] for s in serves[1:])
