"""The port's ``Trainer`` for the MoE and hybrid families against the
reference's, on the CPU, at the sizes of tests/test_torch_train.py (seq 16,
batch 4, fp32, ``q_block=8``, ``xent_chunks=2``, lr 3e-3, warmup 1), from
the reference's own initial weights (its ``init_params``, PRNGKey(0))
carried across.

* 3 steps of the port's ``Trainer`` and of the reference's, for the smoke
  Phi-3.5-MoE (its stacked ``dense0``-less expert blocks, the aux and z
  terms) and the smoke Zamba2 (the (G, 6) stacked Mamba2 groups and the
  unstacked shared block): losses and grad norms within 1e-5 relative.
  Weight decay falls on the reference's leaves of its stacked tree
  (``convert.decays_in_reference``); a leaf decayed on one side and not the
  other moves the second step's loss by ~lr x wd.  The port's Trainer also
  resumes the reference's step-2 checkpoint of each (the stacked groups
  and their moments through ``convert.trainer_state_from_reference``) and
  takes the reference's step 2 within 1e-5.
* Data-parallel Phi-3.5-MoE on 2 gloo ranks (tests/_torch_train_ranks.py)
  against the reference's ``Trainer`` on a (2, 1) mesh of 2 virtual devices
  (a JAX subprocess), both starting with the module:
  - ``grad_compression="none"``: each data shard routes its own rows, and
    the reference's aux and z leave its ``shard_map`` under an unchecked
    ``P()`` out-spec, so each device holds its own shard's terms.  Its
    gradient is that of the whole batch's mean cross-entropy plus the mean
    of the shards' aux and z terms (the transpose divides the replicated
    output's cotangent by the group's size), and its printed loss is
    device 0's copy: the cross-entropy plus shard 0's terms.  The port
    computes the function whose gradient that is (ROADMAP §3): its loss is
    held to the mean of the reference's per-device copies and its grad norm
    to the reference's, within 1e-5; the reference's printed loss is shown
    to be its device 0's copy.
  - ``"int8"``: both train each shard's local-mode LM (every expert on
    every token, ``moe_apply_dense``) and average the compressed gradients;
    the first loss within 1e-5, the rest within ``INT8_TOL`` (as
    tests/test_torch_train.py holds the dense run).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_train_ranks as TR
from repro import configs as rconfigs
from repro.core.meshutil import make_mesh as ref_mesh
from repro.models import lm as rlm
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm as plm
from repro_torch.models.convert import lm_params_from_reference
from repro_torch.runtime import TrainConfig, Trainer

TESTS = Path(__file__).resolve().parent
TRAINER_ARCHS = ("phi35_moe_42b", "zamba2_2p7b")
STEP_TOL, INT8_TOL = 1e-5, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (dataclasses.replace(rconfigs.smoke(arch), dtype="float32"),
            dataclasses.replace(configs.smoke(arch), dtype="float32"))


def _init(arch) -> dict:
    """The reference's initial weights as the port's state dict."""
    rcfg, pcfg = _cfgs(arch)
    ref = rlm.LM(rcfg, ref_mesh((1, 1), ("data", "model")), Axes(multi_pod=False),
                 q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS)
    params = jax.jit(ref.init_params)(jax.random.PRNGKey(0))
    return lm_params_from_reference(pcfg, jax.tree.map(np.asarray, params))


_REFERENCE = """
import dataclasses, json, sys, tempfile
import jax, numpy as np
sys.path.insert(0, {tests!r})
from repro import configs
from repro.core.meshutil import make_mesh
from repro.data import SyntheticLMData
from repro.models.lm import LM
from repro.models.sharding import Axes
from repro.runtime import TrainConfig, Trainer
import _torch_train_ranks as TR


def trainer(arch, mesh, mode="none"):
    cfg = dataclasses.replace(configs.smoke(arch), dtype="float32")
    lm = LM(cfg, mesh, Axes(multi_pod=False), q_block=TR.TRAIN_Q_BLOCK,
            xent_chunks=TR.TRAIN_XENT_CHUNKS)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=TR.TRAIN_SEQ, global_batch=TR.TRAIN_BATCH)
    tc = TrainConfig(steps=TR.TRAIN_STEPS, ckpt_every=100, lr=TR.TRAIN_LR, warmup=TR.TRAIN_WARMUP,
                     ckpt_dir=tempfile.mkdtemp(), grad_compression=mode)
    return Trainer(lm, data, tc), data


out = {{}}
if {dp!r}:
    mesh = make_mesh((TR.WORLD, 1), ("data", "model"))
    for mode in TR.TRAIN_MODES:
        tr, data = trainer(TR.MOE_ARCH, mesh, mode)
        params, opt, _ = tr.init_state()
        err = None
        if mode == "int8":
            err = jax.tree.map(lambda p: jax.numpy.zeros((TR.WORLD, *p.shape), jax.numpy.float32),
                               params)
        hist = []
        for step in range(TR.TRAIN_STEPS):
            batch = jax.device_put(data.host_local_batch(step), tr.bshard)
            if mode == "int8":
                params, opt, err, m = tr.train_step(params, opt, err, batch)
            else:
                params, opt, m = tr.train_step(params, opt, batch)
            hist.append({{"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                          "copies": [float(s.data) for s in m["loss"].addressable_shards]}})
        out[mode] = hist
else:
    import shutil
    for arch in {archs!r}:
        tr, _ = trainer(arch, make_mesh((1, 1), ("data", "model")))
        tr.tc.ckpt_every = 2
        _, _, hist = tr.run()
        out[arch] = {{"loss": [h["loss"] for h in hist],
                      "grad_norm": [h["grad_norm"] for h in hist]}}
        # its step-2 checkpoint alone, for the port to resume
        shutil.copytree(tr.tc.ckpt_dir, {resume!r} + "/" + arch)
        shutil.rmtree({resume!r} + "/" + arch + "/step_0000000003")
open({out!r}, "w").write(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """Starts, when the module starts, the 2 gloo ranks of the data-parallel
    MoE and two reference subprocesses: its data-parallel runs on 2 virtual
    devices, and its single-device Trainers.  Yields the reference's initial
    weights by arch and a function that waits for a run: ``"ranks"`` (each
    rank's histories), ``"dp"`` or ``"trainers"`` (the reference's)."""
    d = tmp_path_factory.mktemp("torch_train_moe")
    init = {arch: _init(arch) for arch in TRAINER_ARCHS}
    np.savez(d / "moe_weights.npz", **{k: v.numpy() for k, v in init[TR.MOE_ARCH].items()})
    join = TR.start(TR.run_train_moe_rank, d, world=TR.WORLD)
    procs = {}
    for name, dp, devices in (("dp", True, TR.WORLD), ("trainers", False, 1)):
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                   PYTHONPATH=str(TESTS.parent / "src"), JAX_PLATFORMS="cpu")
        script = _REFERENCE.format(tests=str(TESTS), dp=dp, archs=TRAINER_ARCHS,
                                   out=str(d / f"{name}.json"), resume=str(d / "resume"))
        procs[name] = subprocess.Popen([sys.executable, "-c", script], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    done = {}

    def wait(name):
        if name not in done:
            if name == "ranks":
                join(timeout=400)
                done[name] = [json.loads((d / f"moe{r}.json").read_text())
                              for r in range(TR.WORLD)]
            else:
                out, _ = procs[name].communicate(timeout=600)
                assert procs[name].returncode == 0, out[-6000:]
                done[name] = json.loads((d / f"{name}.json").read_text())
        return done[name]

    try:
        yield init, wait, d / "resume"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_matches_reference(runs, arch, tmp_path):
    init, wait, _ = runs
    pcfg = _cfgs(arch)[1]
    lm = plm.LM(pcfg, q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS, device="cpu")
    lm.load_state_dict(init[arch])
    data = SyntheticLMData(vocab=pcfg.vocab, seq_len=TR.TRAIN_SEQ, global_batch=TR.TRAIN_BATCH)
    tc = TrainConfig(steps=TR.TRAIN_STEPS, ckpt_every=100, ckpt_dir=str(tmp_path), lr=TR.TRAIN_LR,
                     warmup=TR.TRAIN_WARMUP)
    _, _, got = Trainer(lm, data, tc).run()
    want = wait("trainers")[arch]
    assert [h["step"] for h in got] == [0, 1, 2]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in got], want[key], rtol=STEP_TOL, err_msg=key)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_resume_from_a_reference_checkpoint(runs, arch):
    """The port's Trainer resumes the reference's step-2 checkpoint (the
    stacked expert blocks, or the hybrid's (G, 6) groups and its shared
    block, and their moments, by ``convert.trainer_state_from_reference``)
    and takes the reference's own step 2."""
    _, wait, resume = runs
    want = wait("trainers")[arch]
    pcfg = _cfgs(arch)[1]
    lm = plm.LM(pcfg, q_block=TR.TRAIN_Q_BLOCK, xent_chunks=TR.TRAIN_XENT_CHUNKS, device="cpu",
                seed=9)  # its own weights, overwritten by the restore
    data = SyntheticLMData(vocab=pcfg.vocab, seq_len=TR.TRAIN_SEQ, global_batch=TR.TRAIN_BATCH)
    tc = TrainConfig(steps=TR.TRAIN_STEPS, ckpt_every=100, ckpt_dir=str(resume / arch),
                     lr=TR.TRAIN_LR, warmup=TR.TRAIN_WARMUP)
    _, _, got = Trainer(lm, data, tc).run()
    assert [h["step"] for h in got] == [2]
    for key in ("loss", "grad_norm"):
        assert abs(got[0][key] - want[key][2]) <= STEP_TOL * abs(want[key][2]), (key, got, want)


def test_data_parallel_moe_without_compression(runs):
    """The reference's printed loss is its device 0's copy; the port's is
    the mean of the devices' copies (the function whose gradient both
    take), and the grad norms agree."""
    ranks, ref = runs[1]("ranks"), runs[1]("dp")["none"]
    for step in ref:
        assert step["loss"] == step["copies"][0] and len(step["copies"]) == TR.WORLD
    want_loss = [float(np.mean(step["copies"])) for step in ref]
    for r in ranks:
        got = r["none"]
        np.testing.assert_allclose([h["loss"] for h in got], want_loss, rtol=STEP_TOL)
        np.testing.assert_allclose([h["grad_norm"] for h in got], [s["grad_norm"] for s in ref],
                                   rtol=STEP_TOL)
        # the metrics: the whole batch's cross-entropy plus the mean terms
        for h in got:
            assert h["loss"] > h["xent"] and np.isfinite(h["aux"])
    assert ranks[0]["none"] == ranks[1]["none"]


def test_data_parallel_moe_int8(runs):
    ranks, ref = runs[1]("ranks"), runs[1]("dp")["int8"]
    for step in ref:  # pmean'd: every device holds the same loss
        assert step["copies"] == [step["loss"]] * TR.WORLD
    for r in ranks:
        got = r["int8"]
        np.testing.assert_allclose(got[0]["loss"], ref[0]["loss"], rtol=STEP_TOL)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose([h[key] for h in got], [s[key] for s in ref],
                                       rtol=INT8_TOL, err_msg=key)
        # the metrics: the ranks' mean cross-entropy and terms, apart
        for h in got:
            assert h["loss"] > h["xent"] and np.isfinite(h["aux"])
    assert ranks[0]["int8"] == ranks[1]["int8"]
