"""The port's training path for the dense family against the reference's,
on the CPU, at the smoke size of tests/test_runtime.py (GLM-4-9B's smoke
config, ``q_block=8``, ``xent_chunks=2``, seq 16, batch 4), from the
reference's own initial weights carried across
(``convert.lm_params_from_reference``) and the same tokens
(``repro_torch.data``, bitwise the reference's).

* ``LM.loss`` and its gradients against ``jax.value_and_grad(lm.loss)``:
  fp32 under the baseline and the ``OPTIMIZED`` flags, the loss within
  1e-6 relative and every gradient leaf within 1e-5 relative L2; bf16
  within 3e-2 (tests/test_torch_lm.py's limit).  The reference's bf16
  optimized flags leave out ``bf16_attention``, which its CPU backend
  cannot run, as in tests/test_torch_lm.py.
* No remat, ``"full"`` and ``"dots"`` give bitwise the same loss and
  gradients (fp32 and bf16).
* The ``Trainer``: 3 steps of the port and of the reference's from the same
  state, fp32: losses and grad norms within 1e-5 relative; 4 steps, a
  preemption, and 2 resumed steps bitwise equal to 6 uninterrupted ones
  (weights, moments, losses); the port resuming a checkpoint that the
  reference's ``Trainer`` wrote takes the reference's own resumed step
  within 1e-5; data-parallel on 2 gloo ranks (tests/_torch_train_ranks.py)
  against the reference on a (2, 1) mesh of 2 virtual devices (a JAX
  subprocess; both start with the module and run beside its other tests): within 1e-5 without compression,
  and with ``grad_compression="int8"`` the first loss (before any wire)
  within 1e-5 and the rest within ``INT8_TOL``: each side quantizes its own, nearly equal, fp32
  gradients, so a value on a rounding boundary lands one quantum apart,
  and Adam's first steps move a weight by about lr whatever its gradient's
  size (0 against one quantum is a step of 0 against lr: 1.8e-4 of the
  second step's loss at lr 3e-3); the heartbeat, ``SLOW_STEP`` and the
  SIGTERM save; ``launch.train`` and the ``lm_pretrain`` twin on the CPU,
  and ``launch.train`` under two ranks; ``launch.train --model-parallel 2
  --sp-mode ulysses`` under the two ranks (a (1, 2) mesh) resuming the
  step-1 checkpoint of the reference's own CLI with those options (its
  (1, 2) mesh of the subprocess's 2 devices), its steps 1 and 2 within
  the bf16 limit (3e-2; the CLI trains the smoke config in bf16) of the
  reference CLI's.
* Every mesh-less LM of the registry trains (``loss_not_ported`` is None;
  the other families: tests/test_torch_train_families.py; the dense family
  on a mesh: tests/test_torch_train_tp.py); the forms not ported yet raise,
  naming ROADMAP §1, for a family still unported on a mesh (Phi-3.5-MoE):
  the loss of its LM on a mesh, a ``Trainer`` of one, ``launch.train
  --model-parallel 2`` and ``--sp-mode ulysses``.
"""

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_train_ranks as TR
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh as ref_mesh
from repro.data import SyntheticLMData as RefData
from repro.models import lm as rlm
from repro.models.sharding import Axes
from repro.runtime import TrainConfig as RefTrainConfig, Trainer as RefTrainer
from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm as plm
from repro_torch.models.convert import lm_params_from_reference
from repro_torch.runtime import TrainConfig, Trainer

TESTS = Path(__file__).resolve().parent
ARCH, SEQ, BATCH = TR.TRAIN_ARCH, TR.TRAIN_SEQ, TR.TRAIN_BATCH
LOSS_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
STEP_TOL = 1e-5
INT8_TOL = 1e-3
FLAG_CASES = [("float32", False), ("float32", True), ("bfloat16", False), ("bfloat16", True)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the host's cores, and the
    small ops here lose more to a crowded thread pool than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype: str):
    return (dataclasses.replace(rconfigs.smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.smoke(ARCH), dtype=dtype))


def _ref_lm(cfg, opt: bool, mesh=None):
    flags = rlm.OPTIMIZED if opt else rlm.PerfFlags()
    if opt and cfg.dtype == "bfloat16":
        flags = dataclasses.replace(flags, bf16_attention=False)
    mesh = mesh or ref_mesh((1, 1), ("data", "model"))
    return rlm.LM(cfg, mesh, Axes(multi_pod=False), q_block=TR.TRAIN_Q_BLOCK,
                  xent_chunks=TR.TRAIN_XENT_CHUNKS, perf=flags)


def _port_lm(cfg, opt: bool = False, state=None, remat=None):
    flags = plm.OPTIMIZED if opt else plm.PerfFlags()
    if remat is not None:
        flags = dataclasses.replace(flags, remat_policy=remat)
    lm = plm.LM(cfg, q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS, perf=flags,
                device="cpu")
    if state is not None:
        lm.load_state_dict(state)
    return lm


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def ref_init():
    """The reference's initial weights (PRNGKey(0)) of each dtype, as the
    port's state dict."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = _cfgs(dtype)
        out[dtype] = lm_params_from_reference(
            pcfg, _np(_ref_lm(rcfg, False).init_params(jax.random.PRNGKey(0))))
    return out


def _port_loss_and_grads(lm, batch):
    params = lm.trainable_params()
    loss, _ = lm.loss(batch)
    loss.backward()
    return loss.detach(), {k: p.grad.clone() for k, p in params.items()}


@pytest.mark.parametrize("dtype,opt", FLAG_CASES,
                         ids=[f"{d}-{'opt' if o else 'base'}" for d, o in FLAG_CASES])
def test_loss_and_grads_match_reference(ref_init, dtype, opt):
    rcfg, pcfg = _cfgs(dtype)
    ref = _ref_lm(rcfg, opt)
    params = ref.init_params(jax.random.PRNGKey(0))
    batch = RefData(vocab=rcfg.vocab, seq_len=SEQ, global_batch=BATCH).batch(3)
    (want, _), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(params, batch)
    want_g = lm_params_from_reference(pcfg, _np(grads))
    got, got_g = _port_loss_and_grads(
        _port_lm(pcfg, opt, ref_init[dtype]),
        SyntheticLMData(vocab=pcfg.vocab, seq_len=SEQ, global_batch=BATCH).batch(3))
    assert abs(got.item() - float(want)) <= LOSS_TOL[dtype] * abs(float(want))
    assert got_g.keys() == want_g.keys()
    for k, w in want_g.items():
        rel = float(torch.linalg.vector_norm(got_g[k].float() - w.float())
                    / torch.linalg.vector_norm(w.float()))
        assert rel <= GRAD_TOL[dtype], (k, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_policies_are_bitwise(ref_init, dtype):
    """No remat, "full" and "dots" (with the optimized flags otherwise)."""
    pcfg = _cfgs(dtype)[1]
    batch = SyntheticLMData(vocab=pcfg.vocab, seq_len=SEQ, global_batch=BATCH).batch(1)
    runs = {pol: _port_loss_and_grads(_port_lm(pcfg, True, ref_init[dtype], remat=pol), batch)
            for pol in plm.REMAT_POLICIES}
    loss0, grads0 = runs["none"]
    for pol, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), pol
        assert all(torch.equal(grads[k], grads0[k]) for k in grads0), pol


#: a family whose training on a mesh is not ported yet
UNPORTED_ON_A_MESH = "phi35_moe_42b"


def _unported(case: str):
    """Each training form not ported yet for ``UNPORTED_ON_A_MESH`` (ROADMAP
    §1): the loss of its LM on a mesh (tensor-parallel training; a one-rank
    gloo mesh), a Trainer of such an LM, and the CLI's tensor- and
    sequence-parallel options."""
    from repro_torch.core.meshutil import default_group
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    if case.startswith("cli"):
        argv = ["--model-parallel", "2"] if case == "cli-model-parallel" else ["--sp-mode",
                                                                              "ulysses"]
        return train.main(["--arch", UNPORTED_ON_A_MESH, "--device", "cpu", *argv])
    with default_group("cpu"):
        lm = plm.LM(configs.smoke(UNPORTED_ON_A_MESH), mesh=make_host_mesh(1, device="cpu"),
                    device="cpu")
        if case == "loss-on-a-mesh":
            return lm.loss(_data().batch(0))
        return Trainer(lm, _data(), TrainConfig())


@pytest.mark.parametrize("case", ["loss-on-a-mesh", "trainer-of-a-mesh-lm", "cli-model-parallel",
                                  "cli-ulysses"])
def test_unported_training_forms_raise_naming_the_roadmap(case):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _unported(case)


def test_every_mesh_less_family_trains():
    """``loss_not_ported`` is None for a mesh-less LM of every arch."""
    for arch in rconfigs.ARCH_NAMES:
        assert plm.LM(configs.smoke(arch), device="cpu").loss_not_ported() is None, arch


def _data():
    return SyntheticLMData(vocab=configs.smoke(ARCH).vocab, seq_len=SEQ, global_batch=BATCH)


def _tc(d, steps, **kw):
    return TrainConfig(steps=steps, ckpt_every=100, ckpt_dir=str(d), lr=TR.TRAIN_LR,
                       warmup=TR.TRAIN_WARMUP, **kw)


def _ref_tc(d, steps):
    return RefTrainConfig(steps=steps, ckpt_every=100, ckpt_dir=str(d), lr=TR.TRAIN_LR,
                          warmup=TR.TRAIN_WARMUP)


@pytest.fixture(scope="module")
def ref_trainer(tmp_path_factory):
    """The reference's Trainer, fp32: 3 steps from its init, a checkpoint at
    step 2 among them; then, on a copy of its directory without the final
    step-3 checkpoint, a second reference Trainer resumes at step 2 (its own
    resumed step), and a second copy is kept for the port."""
    d = tmp_path_factory.mktemp("ref_trainer")
    rcfg = _cfgs("float32")[0]
    lm = _ref_lm(rcfg, False)
    data = RefData(vocab=rcfg.vocab, seq_len=SEQ, global_batch=BATCH)
    tc = _ref_tc(d / "three", 3)
    _, _, three = RefTrainer(lm, data, dataclasses.replace(tc, ckpt_every=2)).run()
    for name in ("resume", "for_port"):
        shutil.copytree(d / "three", d / name)
        shutil.rmtree(d / name / "step_0000000003")
    _, _, resumed = RefTrainer(lm, data, _ref_tc(d / "resume", 3)).run()
    return three, resumed, d / "for_port"


def test_trainer_matches_reference(ref_init, ref_trainer, tmp_path):
    want = ref_trainer[0]
    _, _, got = Trainer(_port_lm(_cfgs("float32")[1], state=ref_init["float32"]), _data(),
                        _tc(tmp_path, 3)).run()
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for g, w in zip(got, want):
        for key in ("loss", "grad_norm"):
            assert abs(g[key] - w[key]) <= STEP_TOL * abs(w[key]), (g, w)


def test_resume_from_a_reference_checkpoint(ref_trainer):
    """The port's Trainer resumes the reference's step-2 checkpoint (its
    stacked keys mapped by ``convert.trainer_state_from_reference``)."""
    want = ref_trainer[1]
    lm = _port_lm(_cfgs("float32")[1])  # its own weights, overwritten by the restore
    _, _, got = Trainer(lm, _data(), _tc(ref_trainer[2], 3)).run()
    assert [h["step"] for h in got] == [h["step"] for h in want] == [2]
    assert abs(got[0]["loss"] - want[0]["loss"]) <= STEP_TOL * abs(want[0]["loss"])
    assert abs(got[0]["grad_norm"] - want[0]["grad_norm"]) <= STEP_TOL * want[0]["grad_norm"]


def test_resume_is_bitwise(tmp_path):
    """4 steps, a preemption (the stop flag SIGTERM sets), 2 resumed steps
    in a new Trainer: bitwise the 6 steps of one run (bf16, the
    optimized flags)."""
    cfg = configs.smoke(ARCH)
    first = Trainer(_port_lm(cfg, True), _data(), _tc(tmp_path / "a", 6))

    def stop(m):
        if m["step"] == 3:
            first._stop = True

    _, _, h1 = first.run(on_metrics=stop)
    p2, o2, h2 = Trainer(_port_lm(cfg, True), _data(), _tc(tmp_path / "a", 6)).run()
    p3, o3, h3 = Trainer(_port_lm(cfg, True), _data(), _tc(tmp_path / "b", 6)).run()
    assert [h["step"] for h in h1] == [0, 1, 2, 3] and [h["step"] for h in h2] == [4, 5]
    assert [h["loss"] for h in h1 + h2] == [h["loss"] for h in h3]
    assert all(torch.equal(p2[k], p3[k]) for k in p3)
    assert all(torch.equal(o2.mu[k], o3.mu[k]) and torch.equal(o2.nu[k], o3.nu[k]) for k in p3)
    assert int(o2.step) == int(o3.step) == 6


def test_heartbeat_slow_step_and_sigterm(tmp_path):
    """A step 1 s slower than the rest after 9 others logs SLOW_STEP; a
    SIGTERM during step 11 saves step 12 and ends the run."""
    tr = Trainer(_port_lm(configs.smoke(ARCH)), _data(), _tc(tmp_path, 50))
    real, calls = tr.train_step, []

    def slow_tenth(*a):
        calls.append(1)
        if len(calls) == 10:
            time.sleep(1.0)
        return real(*a)

    def term(m):
        if m["step"] == 11:
            os.kill(os.getpid(), signal.SIGTERM)

    tr.train_step = slow_tenth
    _, _, hist = tr.run(on_metrics=term)
    assert [h["step"] for h in hist] == list(range(12))
    lines = [json.loads(x) for x in (tmp_path / "heartbeat.log").read_text().splitlines()]
    assert [r.get("event") for r in lines if r.get("event")] == ["SLOW_STEP",
                                                                 "PREEMPTED_CLEAN_EXIT"]
    assert next(r for r in lines if r.get("event") == "SLOW_STEP")["step"] == 9
    assert tr.ckpt.latest_step() == 12
    assert signal.getsignal(signal.SIGTERM) is not tr._signal


def test_train_cli_and_pretrain_twin_on_the_cpu(tmp_path, monkeypatch):
    from repro_torch.examples import lm_pretrain
    from repro_torch.launch import train

    hist = train.main(["--arch", ARCH, "--preset", "smoke", "--steps", "3", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path / "cli")])
    assert [h["step"] for h in hist] == [0, 1, 2] and all(np.isfinite(h["loss"]) for h in hist)
    monkeypatch.setitem(lm_pretrain.PRESETS, "10m", dict(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, head_dim=8,
        seq=64, batch=2))
    hist = lm_pretrain.main(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "pretrain")])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


_REFERENCE_DP = """
import dataclasses, json, sys, tempfile
sys.path.insert(0, {tests!r})
from repro import configs
from repro.core.meshutil import make_mesh
from repro.data import SyntheticLMData
from repro.models.lm import LM
from repro.models.sharding import Axes
from repro.runtime import TrainConfig, Trainer
import _torch_train_ranks as TR
from repro.launch import train as cli

# the reference's CLI with --model-parallel 2 --sp-mode ulysses (a (1, 2)
# mesh of the 2 devices), a checkpoint each step, for the port's CLI to resume
run, cli_hist = cli.Trainer.run, []


def recorded(self, *args, **kwargs):
    out = run(self, *args, **kwargs)
    cli_hist.append(out[2])
    return out


cli.Trainer.run = recorded
cli.main([*TR.TP_CLI_ARGV, "--steps", str(TR.TP_CLI_STEPS), "--ckpt-every", "1",
          "--ckpt-dir", {ref_cli!r}])
cli.Trainer.run = run
open({ref_cli!r} + ".done", "w").close()

mesh = make_mesh((TR.WORLD, 1), ("data", "model"))
cfg = dataclasses.replace(configs.smoke(TR.TRAIN_ARCH), dtype="float32")
lm = LM(cfg, mesh, Axes(multi_pod=False), q_block=TR.TRAIN_Q_BLOCK,
        xent_chunks=TR.TRAIN_XENT_CHUNKS)
data = SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ, global_batch=TR.TRAIN_BATCH)
out = {{}}
for mode in TR.TRAIN_MODES:
    tc = TrainConfig(steps=TR.TRAIN_STEPS, ckpt_every=100, lr=TR.TRAIN_LR,
                     warmup=TR.TRAIN_WARMUP, ckpt_dir=tempfile.mkdtemp(), grad_compression=mode)
    _, _, hist = Trainer(lm, data, tc).run()
    out[mode] = {{"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist]}}
out["tp_cli"] = {{k: [h[k] for h in cli_hist[0]] for k in ("step", "loss", "grad_norm")}}
open({out!r}, "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _dp_started(ref_init, tmp_path_factory):
    """Starts the data-parallel runs when the module starts, so that they
    run beside the in-process tests: the 2 gloo ranks and the reference's
    JAX subprocess on 2 virtual devices.  Yields a function that waits for
    both and returns (each rank's histories, the reference's)."""
    d = tmp_path_factory.mktemp("torch_train_dp")
    np.savez(d / "weights.npz", **{k: v.numpy() for k, v in ref_init["float32"].items()})
    join = TR.start(TR.run_train_rank, d, world=TR.WORLD)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={TR.WORLD}",
               PYTHONPATH=str(TESTS.parent / "src"))
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE_DP.format(
        tests=str(TESTS), out=str(d / "reference.json"), ref_cli=str(d / "ref_cli"))], env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    done = {}

    def wait():
        if not done:
            try:
                out, _ = proc.communicate(timeout=600)
                assert proc.returncode == 0, out[-6000:]
            finally:
                join(timeout=400)
            done["runs"] = ([json.loads((d / f"train{r}.json").read_text())
                             for r in range(TR.WORLD)],
                            json.loads((d / "reference.json").read_text()))
        return done["runs"]

    try:
        yield wait
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture
def dp_runs(_dp_started):
    return _dp_started()


@pytest.mark.parametrize("mode", TR.TRAIN_MODES)
def test_data_parallel_matches_reference(dp_runs, mode):
    ranks, ref = dp_runs
    tol = STEP_TOL if mode == "none" else INT8_TOL
    for key in ("loss", "grad_norm"):
        want = np.array(ref[mode][key])
        for r in ranks:
            got = np.array(r[mode][key])
            assert got.shape == want.shape == (TR.TRAIN_STEPS,)
            if key == "loss":  # the first step's loss is before any wire
                np.testing.assert_allclose(got[0], want[0], rtol=STEP_TOL, err_msg=mode)
            np.testing.assert_allclose(got, want, rtol=tol, err_msg=f"{mode} {key}")
    assert ranks[0][mode] == ranks[1][mode]  # the ranks hold one model


def test_train_cli_under_two_ranks(dp_runs):
    ranks, _ = dp_runs
    losses = [r["cli"]["loss"] for r in ranks]
    assert len(losses[0]) == 2 and losses[0] == losses[1] and np.isfinite(losses[0]).all()


def test_train_cli_tensor_and_sequence_parallel_matches_reference(dp_runs):
    """``launch.train --model-parallel 2 --sp-mode ulysses`` under two gloo
    ranks resumes the reference CLI's step-1 checkpoint and takes steps 1
    and 2 within the smoke config's dtype limit (bf16: 3e-2, ``LOSS_TOL``)
    of the reference CLI's own (its step 0 is the reference's alone: the
    weights are drawn by its PRNG)."""
    ranks, ref = dp_runs
    want = ref["tp_cli"]
    tol = LOSS_TOL[configs.smoke(ARCH).dtype]
    assert want["step"] == list(range(TR.TP_CLI_STEPS))
    for r in ranks:
        got = r["tp_cli"]
        assert got["step"] == want["step"][1:]
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(got[key], want[key][1:], rtol=tol, err_msg=key)
    assert ranks[0]["tp_cli"] == ranks[1]["tp_cli"]
