"""The dense family's training on a ``("data", "model")`` mesh
(``LM(cfg, mesh=, sp_mode=)``, ``perf.seq_sharded_residual``) against the
reference's ``LM`` on the same mesh shape, on the CPU.

The ranks are spawned once per mesh, (1, 2), (2, 2) and (1, 4) of gloo
ranks (tests/_torch_train_ranks.py ``run_train_tp_rank``), all at once,
while one JAX subprocess per mesh runs the reference there (4 virtual
devices at most).  The weights are the reference's own initial weights
(``PRNGKey(0)``, carried across by ``convert.lm_params_from_reference``)
of the smoke GLM-4-9B (at every mesh) and Nemotron-4-15B (at (1, 2)) in
fp32, through one npz; the
reference's side stacks the layers back.  The batch is the seeded stream's
(``repro_torch.data``, bitwise the reference's), seq 16, batch 4.

* ``LM.loss`` in each of the four forms (``sp_mode`` "none" / "ulysses" x
  ``seq_sharded_residual`` off / on) at each of its meshes, each data rank on its
  rows over the whole batch's mask count, the ranks' losses and gradients
  summed over "data" and the partial ones over "model"
  (``LM.sum_partial_grads``): the loss within 1e-6 relative of the
  reference's, every gathered gradient leaf within 1e-5 relative L2; one
  case with a vocabulary of 250 that (1, 4) does not divide (the reference
  pads it to 252, its padded head columns seeded, and they enter the
  logsumexp: their gradient is not zero); the gradients of every rank
  bitwise equal (the whole leaves' after the sum); the collectives of the
  loss and its backward exactly ``LM.collectives_per_step``.
* ``ulysses_attention`` on rank blocks against the reference's
  ``blockwise_attention`` on the whole sequence, values and gradients within
  2e-4 (tests/test_attention.py's limit), at (1, 2) and at (1, 4) where the
  2 kv heads are repeated to 4, causal and not.
* The ``Trainer`` on (2, 2), Ulysses with the sequence-sharded residual: 3
  steps within 1e-5 of the reference's ``Trainer`` (its initial state set to
  the same weights); 4 steps, a stop asked of one rank alone (every rank
  stops after the same step) and 2 resumed steps on the same mesh bitwise
  6 uninterrupted ones; a checkpoint that a Trainer on (1, 2) wrote
  restored by a mesh-less Trainer, every leaf (weights and both moments)
  equal to the whole leaf the ranks gathered.
* ``Shard.gather_leaves`` and ``gather_to_lead`` on seeded leaves, and a
  stop that one rank alone is asked for, at every mesh.
* The placement rules (``sharding.split_dim``, ``grad_summed_over_model``)
  and the refusals: Ulysses for another family, a sequence tp does not
  divide.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_train_ranks as TR
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh as ref_mesh
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm as plm
from repro_torch.models import sharding
from repro_torch.models.convert import lm_params_from_reference
from repro_torch.runtime import TrainConfig, Trainer

TESTS = Path(__file__).resolve().parent
LOSS_TOL, GRAD_TOL, STEP_TOL, ULYSSES_TOL = 1e-6, 1e-5, 1e-5, 2e-4

_REFERENCE = """
import dataclasses, json, sys, tempfile
sys.path.insert(0, {tests!r})
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_disable_most_optimizations", True)  # compiles are the critical path
from repro import configs
from repro.core.meshutil import make_mesh, set_mesh
from repro.data import SyntheticLMData
from repro.models import lm as rlm
from repro.models.sharding import Axes
from repro.runtime import TrainConfig, Trainer
from repro_torch import configs as pconfigs
from repro_torch.models.convert import lm_params_from_reference
import _torch_train_ranks as TR

weights = np.load(TR.wait_for({weights!r}))
shape = {shape!r}
mesh = make_mesh(shape, ("data", "model"))


def tree(prefix, abstract):
    # the reference's tree of the port's per-layer leaves, the layers stacked
    def leaf(path, a):
        names = [k.key for k in path]
        if names[0] == "blocks":
            x = np.stack([weights[prefix + ":" + ".".join(["blocks", str(i), *names[1:]])]
                          for i in range(a.shape[0])])
        else:
            x = weights[prefix + ":" + ".".join(names)]
        return jnp.asarray(x, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, abstract)


def model(arch, vocab, form):
    cfg = TR.tp_config(configs, arch, vocab)
    return cfg, rlm.LM(cfg, mesh, Axes(multi_pod=False), q_block=TR.TRAIN_Q_BLOCK,
                       xent_chunks=TR.TRAIN_XENT_CHUNKS, sp_mode=form[0],
                       perf=rlm.PerfFlags(seq_sharded_residual=form[1]))


res, info = {{}}, {{}}
with set_mesh(mesh):
    for arch, vocab, form in TR.tp_loss_cases(shape):
        key = TR.tp_key(arch, vocab, form)
        cfg, ref = model(arch, vocab, form)
        params = tree(TR.tp_wkey(arch, vocab), ref.abstract_params())
        batch = SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ,
                                global_batch=TR.TRAIN_BATCH).batch(TR.TP_BATCH_STEP)
        (loss, _), g = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, batch)
        res[key + "|loss"] = np.asarray(loss)
        pg = lm_params_from_reference(TR.tp_config(pconfigs, arch, vocab),
                                      jax.tree.map(np.asarray, g))
        for k, t in pg.items():
            res[key + "|g|" + k] = t.numpy()
    if shape == (2, 2):
        cfg, ref = model(TR.TRAIN_ARCH, None, TR.TP_TRAIN_FORM)
        data = SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ, global_batch=TR.TRAIN_BATCH)
        tr = Trainer(ref, data, TrainConfig(steps=TR.TRAIN_STEPS, ckpt_every=100, lr=TR.TRAIN_LR,
                                            warmup=TR.TRAIN_WARMUP, ckpt_dir=tempfile.mkdtemp()))
        params = jax.device_put(tree(TR.TRAIN_ARCH, ref.abstract_params()), tr.pshard)
        state = (params, jax.jit(tr.opt.init, out_shardings=tr.oshard)(params), 0)
        tr.init_state = lambda seed=0: state
        hist = tr.run()[2]
        info["trainer"] = {{"loss": [h["loss"] for h in hist],
                           "grad_norm": [h["grad_norm"] for h in hist]}}
np.savez({out!r}, **res)
open({info_out!r}, "w").write(json.dumps(info))
"""


def _tag(shape) -> str:
    return "x".join(map(str, shape))


def _ref_init(arch, vocab=None) -> dict[str, np.ndarray]:
    """The reference's initial weights of ``arch`` (fp32, at ``vocab``) on a
    (1, 1) mesh as the port's state dict."""
    cfg = TR.tp_config(rconfigs, arch, vocab)
    ref = rlm.LM(cfg, ref_mesh((1, 1), ("data", "model")), Axes(multi_pod=False))
    params = jax.tree.map(np.asarray, jax.jit(ref.init_params)(jax.random.PRNGKey(0)))
    return {k: t.numpy() for k, t in lm_params_from_reference(
        TR.tp_config(configs, arch, vocab), params).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(ranks, reference, directory)``: by mesh tag, each rank's (arrays,
    info); the reference's (arrays, info) by mesh tag."""
    d = tmp_path_factory.mktemp("torch_train_tp")
    joins, procs = [], {}
    for shape in TR.TP_MESHES:
        (d / _tag(shape)).mkdir()
        joins.append(TR.start(functools.partial(TR.run_train_tp_rank, mesh_shape=shape),
                              d / _tag(shape), world=shape[0] * shape[1]))
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"))
    for shape in TR.TP_MESHES:
        env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={shape[0] * shape[1]} "
                            "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
        code = _REFERENCE.format(tests=str(TESTS), weights=str(d / "weights.npz"), shape=shape,
                                 out=str(d / f"ref{_tag(shape)}.npz"),
                                 info_out=str(d / f"ref{_tag(shape)}.json"))
        procs[shape] = subprocess.Popen([sys.executable, "-c", code], env=dict(env),
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
    # the weights, while the ranks and subprocesses start (they wait for them)
    weights = {}
    for arch in TR.TP_ARCHS:
        weights.update({f"{arch}:{k}": v for k, v in _ref_init(arch).items()})
    (shape, arch, vocab, _) = TR.TP_PAD
    gran = shape[0] * shape[1]  # the reference's vocab_padded rule: model x data
    padded = -(-vocab // gran) * gran
    weights.update({f"{TR.tp_wkey(arch, vocab)}:{k}": v
                    for k, v in TR.pad_vocab(_ref_init(arch, vocab), padded).items()})
    np.savez(d / "weights.tmp.npz", **weights)
    os.replace(d / "weights.tmp.npz", d / "weights.npz")
    try:
        for shape, proc in procs.items():
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-6000:]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for join in joins:
            join(timeout=400)
    ranks = {_tag(s): [(dict(np.load(d / _tag(s) / f"tp{r}.npz")),
                        json.loads((d / _tag(s) / f"tp{r}.json").read_text()))
                       for r in range(s[0] * s[1])] for s in TR.TP_MESHES}
    ref = {_tag(s): (dict(np.load(d / f"ref{_tag(s)}.npz")),
                     json.loads((d / f"ref{_tag(s)}.json").read_text())) for s in TR.TP_MESHES}
    return ranks, ref, d


CASES = [(shape, case) for shape in TR.TP_MESHES for case in TR.tp_loss_cases(shape)]
CASE_IDS = [f"{_tag(s)}-{TR.tp_key(*c).replace(':', '-')}" for s, c in CASES]


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got.astype(np.float64) - want)
                 / max(np.linalg.norm(want.astype(np.float64)), 1e-30))


@pytest.mark.parametrize("shape,case", CASES, ids=CASE_IDS)
def test_loss_and_grads_match_reference(runs, shape, case):
    """Every rank's loss (summed over "data") within 1e-6 of the reference's
    on the same mesh shape, every gathered gradient leaf within 1e-5."""
    ranks, ref, _ = runs
    key = TR.tp_key(*case)
    want, _ = ref[_tag(shape)]
    names = [k[len(key) + 3:] for k in want if k.startswith(key + "|g|")]
    assert names
    for arrays, _ in ranks[_tag(shape)]:
        loss, wl = float(arrays[key + "|loss"]), float(want[key + "|loss"])
        assert abs(loss - wl) <= LOSS_TOL * abs(wl), (loss, wl)
        for k in names:
            got, w = arrays[f"{key}|g|{k}"], want[f"{key}|g|{k}"]
            assert got.shape == w.shape, (k, got.shape, w.shape)
            assert _rel_l2(got, w) <= GRAD_TOL, (k, _rel_l2(got, w))
    if case[1]:  # the padded head columns enter the logsumexp: their gradient is not zero
        pad = ranks[_tag(shape)][0][0][f"{key}|g|lm_head"][:, case[1]:]
        assert pad.shape[1] > 0 and np.abs(pad).max() > 0


@pytest.mark.parametrize("shape", TR.TP_MESHES, ids=_tag)
def test_every_rank_holds_the_same_gradients(runs, shape):
    """Every leaf's gathered gradient, bitwise equal on every rank: the
    whole leaves' after the sum over "model", which the Trainer relies on."""
    ranks, _, _ = runs
    arrays0 = ranks[_tag(shape)][0][0]
    for arrays, _ in ranks[_tag(shape)][1:]:
        for k, v in arrays0.items():
            if "|g|" in k or k.endswith("|loss"):
                assert np.array_equal(arrays[k], v), k


@pytest.mark.parametrize("shape", TR.TP_MESHES, ids=_tag)
def test_collectives_match_the_formula(runs, shape):
    """The collectives of ``loss`` and its backward, by kind, exactly
    ``LM.collectives_per_step`` (the recomputation under the "full" remat
    counted), and the placement as the table of ``models/sharding.py``: the
    same in both modes."""
    ranks, _, _ = runs
    for _, info in ranks[_tag(shape)]:
        for key, case in info["cases"].items():
            assert case["counts"] == case["formula"], key
            sp, residual = key.split(":")[1:3]
            attn = {k for k in case["summed"] if ".attn." in k}
            norms = {k for k in case["summed"] if ".attn." not in k}
            kv = {k for k in attn if k.rsplit(".", 1)[1] in ("wk", "wv", "bk", "bv")}
            assert attn == kv and kv, sp
            assert bool(norms) == (residual == "seq")
            assert {"embed", "blocks.0.attn.wq", "blocks.0.attn.wo"} <= set(case["split"])


@pytest.mark.parametrize("shape", TR.TP_MESHES, ids=_tag)
def test_gather_leaves_gives_whole_leaves_and_summed_slices(runs, shape):
    """``Shard.gather_leaves`` (Ulysses' ``wq``, ``bq``, ``wo``): the whole
    leaves on every rank, a column-split and a row-split one in one
    all_gather, and each rank's gradient of its slices the model group's
    sum of the cotangents on them (its reduce_scatter)."""
    ranks, _, _ = runs
    for _, info in ranks[_tag(shape)]:
        assert info["leaves"]["forward"] and info["leaves"]["backward"]


@pytest.mark.parametrize("shape", TR.TP_MESHES, ids=_tag)
def test_gather_to_lead_sends_slices_to_the_first_rank(runs, shape):
    """``Shard.gather_to_lead`` (the mesh checkpoint's): the whole leaf on
    the model group's first rank, split on its columns or its rows, and
    nothing on the others."""
    ranks, _, _ = runs
    for _, info in ranks[_tag(shape)]:
        lead = info["leaves"]["lead"]
        assert lead == ([True, True] if info["leaves"]["model_rank"] == 0 else [None, None])


@pytest.mark.parametrize("shape", TR.TP_MESHES, ids=_tag)
def test_a_stop_asked_of_one_rank_stops_every_rank(runs, shape):
    """A preemption that the last rank alone sees after step 0: every rank
    stops after that step (the ranks' flag agreed by one all_reduce), and
    the checkpoint of step 1 is written."""
    ranks, _, _ = runs
    for _, info in ranks[_tag(shape)]:
        assert info["stop"] == {"steps": [0], "checkpoint": 1}


ULYSSES = [(shape, c) for shape, cases in TR.TP_ULYSSES.items() for c in cases]


@pytest.mark.parametrize("shape,case", ULYSSES,
                         ids=[f"{_tag(s)}-{TR.ulysses_tag(*c)}" for s, c in ULYSSES])
def test_ulysses_attention_matches_blockwise(runs, shape, case):
    """``ulysses_attention`` on the ranks' blocks, gathered, against the
    reference's ``blockwise_attention`` on the whole sequence: the output and
    q, k, v's gradients for a seeded cotangent."""
    ranks, _, _ = runs
    x = TR.ulysses_inputs(*case)

    def f(q, k, v):
        return rattn.blockwise_attention(q, k, v, causal=case[1], q_block=TR.TP_ULYSSES_Q_BLOCK)

    o, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in "qkv"))
    want = {"o": o, **dict(zip(("dq", "dk", "dv"), vjp(jnp.asarray(x["do"]))))}
    tag = TR.ulysses_tag(*case)
    for arrays, _ in ranks[_tag(shape)]:
        for name, w in want.items():
            np.testing.assert_allclose(arrays[f"uly:{tag}|{name}"], np.asarray(w),
                                       rtol=ULYSSES_TOL, atol=ULYSSES_TOL, err_msg=name)


def test_trainer_on_2x2_matches_reference(runs):
    """3 Trainer steps on (2, 2), Ulysses with the sequence-sharded
    residual, within 1e-5 of the reference's Trainer, every rank alike."""
    ranks, ref, _ = runs
    want = ref["2x2"][1]["trainer"]
    for _, info in ranks["2x2"]:
        for key in ("loss", "grad_norm"):
            got = np.array(info["trainer"][key])
            assert got.shape == (TR.TRAIN_STEPS,)
            np.testing.assert_allclose(got, want[key], rtol=STEP_TOL, err_msg=key)


def test_resume_on_a_mesh_is_bitwise(runs):
    """4 steps, a stop, 2 resumed steps equal 6 uninterrupted ones on (2, 2):
    losses, each rank's weights and moments."""
    ranks, _, _ = runs
    for _, info in ranks["2x2"]:
        r = info["resume"]
        assert r["steps"] == [[0, 1, 2, 3], [4, 5]]
        assert r["losses"] and r["params"] and r["moments"]


def test_tp2_checkpoint_restores_without_a_mesh(runs):
    """The checkpoint a Trainer on (1, 2) wrote holds whole leaves: a
    mesh-less Trainer restores it, every weight and moment equal to the
    whole leaf the ranks gathered."""
    _, _, d = runs
    cfg = TR.tp_config(configs, TR.TRAIN_ARCH)
    lm = plm.LM(cfg, q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS, device="cpu",
                seed=9)
    tr = Trainer(lm, SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ,
                                     global_batch=TR.TRAIN_BATCH),
                 TrainConfig(steps=TR.TP_CKPT_STEPS + 1, ckpt_dir=str(d / "1x2" / "tp2ckpt")))
    params, opt, step = tr.restore_or_init()
    whole = np.load(d / "1x2" / "tp2whole.npz")
    assert step == TR.TP_CKPT_STEPS and int(opt.step) == TR.TP_CKPT_STEPS
    for pre, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        assert set(tree) == {k.split("|", 1)[1] for k in whole.files if k.startswith(pre + "|")}
        for k, t in tree.items():
            assert np.array_equal(t.detach().numpy(), whole[f"{pre}|{k}"]), (pre, k)


@pytest.mark.parametrize("seq", [False, True], ids=["whole", "seq"])
def test_placement_rules(seq):
    """The dense leaves lie alike in both modes: ``wq``, ``bq``, ``wo``, the
    MLP, embedding and head split, ``wk``, ``wv`` whole with their gradient
    summed; the norms' gradients summed only under the sequence-sharded
    residual."""
    for leaf, dim in (("wq", 1), ("bq", 0), ("wo", 0), ("wk", None), ("wv", None)):
        assert sharding.split_dim(f"blocks.3.attn.{leaf}") == dim
    for name, dim in (("blocks.0.mlp.w_up", 1), ("blocks.0.mlp.w_down", 0), ("embed", 0),
                      ("lm_head", 1), ("final_norm.w", None), ("blocks.1.ln1.w", None)):
        assert sharding.split_dim(name) == dim

    def summed(name):
        return sharding.grad_summed_over_model(name, seq)

    assert summed("blocks.0.attn.wk") and summed("blocks.0.attn.bv")
    assert not summed("blocks.0.attn.wq") and not summed("blocks.0.attn.wo")
    assert summed("blocks.0.ln2.w") == summed("final_norm.w") == seq
    assert not summed("embed") and not summed("blocks.0.mlp.w_gate")


def test_ulysses_lm_refusals():
    """Ulysses on a mesh for another family, an unknown mode, and a sequence
    that tp does not divide raise (a one-rank gloo mesh can only show the
    first two; the third is ``Shard.seq_block``'s)."""
    from repro_torch.core.meshutil import default_group
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(ValueError, match="sp_mode"):
        plm.LM(configs.smoke("glm4_9b"), device="cpu", sp_mode="ring")
    with default_group("cpu"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            plm.LM(configs.smoke("phi35_moe_42b"), mesh=make_host_mesh(1, device="cpu"),
                   device="cpu", sp_mode="ulysses")
        shard = sharding.Shard(make_host_mesh(1, device="cpu"))
        assert shard.seq_block(16) == (0, 16)
    shard.tp, shard.rank = 4, 3
    assert shard.seq_block(16) == (12, 4)
    with pytest.raises(ValueError, match="does not split"):
        shard.seq_block(18)


def test_mesh_less_lm_ignores_the_mesh_options():
    """Without a mesh ``sp_mode`` and ``seq_sharded_residual`` change no bit
    of the loss or its gradients (bf16, the optimized flags)."""
    cfg = configs.smoke("glm4_9b")
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ,
                            global_batch=TR.TRAIN_BATCH).batch(1)
    out = []
    for sp, seq in TR.TP_FORMS:
        lm = plm.LM(cfg, q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS,
                    device="cpu", sp_mode=sp,
                    perf=dataclasses.replace(plm.OPTIMIZED, seq_sharded_residual=seq))
        params = lm.trainable_params()
        loss, _ = lm.loss(batch)
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in params.items()}))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(g, out[0][1][k]) for k, g in grads.items())
