"""The port's training loss for every family but the dense one against the
reference's, on the CPU: the MoE family (Phi-3.5-MoE; DeepSeek-V2-Lite with
MLA and a leading dense block), the SSM (Falcon-Mamba-7B), the hybrid
(Zamba2-2.7B), the VLM (LLaVA-NeXT-34B) and the audio encoder–decoder
(SeamlessM4T-medium), each at its smoke config, ``q_block=8``,
``xent_chunks=2``, seq 16, batch 4, from the reference's own initial
weights carried across (``convert.lm_params_from_reference``) and the same
tokens (``repro_torch.data``).  The VLM takes its 8 frontend embeddings and
the audio family 20 frames (more than the 16 positions, so that the causal
cross-attention masks some), both numpy-seeded.

* ``LM.loss`` and its gradients against ``jax.value_and_grad(lm.loss)``
  (jitted once a case, the module's cache): fp32 within the dense family's
  limits, the loss 1e-6 relative and each gradient leaf 1e-5 relative L2,
  and the MoE archs' expert choices identical; bf16 within 3e-2, the MoE
  archs' expert choices pinned to the reference's (routing is a step
  function of the router's margins, and a rounding moves a token across
  one).  The scans sum in another order than the reference's associative
  scan, yet meet the fp32 limits (the worst leaf measured: 2.4e-6,
  Zamba2's ``A_log``).  The hybrid's bf16 gradients take 6e-2
  (``BF16_TOL``, the bf16 LM limit of tests/test_torch_hybrid.py): its
  ``dt_bias`` and ``A_log`` gradients are long sums of bf16 products, and
  the reference's own bf16 gradients of them lie up to 4.1e-2 from its
  fp32 ones; the port's are 3.8e-2 from the reference's (measured).
* The MoE archs in ``local_mode`` (``LM.local()``, every expert on every
  token: ``moe_apply_dense``) against the reference's local-mode LM (the
  one its int8 Trainer builds), fp32, the same limits.
* No remat, ``"full"`` and ``"dots"`` give bitwise the same loss and
  gradients for each family, fp32 and bf16.
* The Mamba1 training scan (``ssm.selective_scan`` with gradients on) is
  bit for bit the serving scan and, with its gradients, within 1e-4 of a
  float64 recurrence.
* The audio decoder's training cross-attention is causal, as the
  reference's (ROADMAP §3): a run with a non-causal cross-attention is far
  from the reference's loss.
* ``launch.train --arch <arch> --preset smoke --device cpu`` and the
  ``lm_pretrain`` twin's ``--arch`` (at a cut preset) train 2 steps of
  each family.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.meshutil import make_mesh as ref_mesh
from repro.data import SyntheticLMData as RefData
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models.sharding import Axes
from repro_torch import configs
from repro_torch.data import SyntheticLMData
from repro_torch.models import lm as plm
from repro_torch.models import moe as pmoe
from repro_torch.models import ssm
from repro_torch.models.convert import lm_params_from_reference

TESTS = Path(__file__).resolve().parent
ARCHS = ("phi35_moe_42b", "deepseek_v2_lite_16b", "falcon_mamba_7b", "zamba2_2p7b",
         "llava_next_34b", "seamless_m4t_medium")
MOE_ARCHS = ARCHS[:2]
SEQ, BATCH, FRAMES, Q_BLOCK, XENT_CHUNKS = 16, 4, 20, 8, 2
LOSS_TOL = {"float32": 1e-6, "bfloat16": 3e-2}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
#: the hybrid's bf16 gradient limit (the module docstring)
BF16_TOL = {"zamba2_2p7b": 6e-2}
SCAN_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch: str, dtype: str):
    return (dataclasses.replace(rconfigs.smoke(arch), dtype=dtype),
            dataclasses.replace(configs.smoke(arch), dtype=dtype))


def _frontend(cfg) -> np.ndarray | None:
    """The VLM's frontend embeddings or the audio family's frames, fp32."""
    n = {"vlm": cfg.n_frontend_tokens, "audio": FRAMES}.get(cfg.family)
    if n is None:
        return None
    return np.random.default_rng(7).standard_normal((BATCH, n, cfg.d_model)).astype(np.float32)


def _batches(rcfg, pcfg):
    """The reference's batch (numpy) and the port's (tensors), step 3."""
    ref = {k: np.asarray(v) for k, v in
           RefData(vocab=rcfg.vocab, seq_len=SEQ, global_batch=BATCH).batch(3).items()}
    port = SyntheticLMData(vocab=pcfg.vocab, seq_len=SEQ, global_batch=BATCH).batch(3)
    fe = _frontend(pcfg)
    if fe is not None:
        ref["frontend"], port["frontend"] = fe, torch.from_numpy(fe)
    return ref, port


def _ref_lm(cfg, local: bool = False):
    return rlm.LM(cfg, ref_mesh((1, 1), ("data", "model")), Axes(multi_pod=False),
                  q_block=Q_BLOCK, xent_chunks=XENT_CHUNKS, batch_sharded=not local,
                  local_mode=local)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_init32(arch: str):
    """The reference's fp32 initial weights (PRNGKey(0)), numpy."""
    return _np(jax.jit(_ref_lm(_cfgs(arch, "float32")[0]).init_params)(jax.random.PRNGKey(0)))


def _ref_init(ref, arch: str):
    """The reference's initial weights of ``ref``'s dtype: it draws every
    leaf in fp32 and casts it, so the bf16 weights are the fp32 ones cast
    to the dtypes of its bf16 tree."""
    dtypes = jax.eval_shape(ref.init_params, jax.random.PRNGKey(0))
    return jax.tree.map(lambda a, t: np.asarray(a).astype(t.dtype),
                        _ref_init32(arch), dtypes)


def _ref_case(arch: str, dtype: str, local: bool):
    """The reference's initial weights (PRNGKey(0)) as the port's state dict,
    its loss, aux and gradients of step 3's batch, and each expert layer's
    expert ids (the forward's; the backward's recomputation routes again)."""
    rcfg, pcfg = _cfgs(arch, dtype)
    ref = _ref_lm(rcfg, local)
    params = _ref_init(ref, arch)
    batch = _batches(rcfg, pcfg)[0]
    ids, route = [], rmoe.route

    def recording(w, x, k):
        out = route(w, x, k)
        jax.debug.callback(lambda i: ids.append(np.asarray(i)), out[1])
        return out

    rmoe.route = recording
    try:
        (loss, metrics), grads = jax.jit(jax.value_and_grad(ref.loss, has_aux=True))(
            params, batch)
        jax.block_until_ready(grads)
    finally:
        rmoe.route = route
    n_moe = pcfg.n_layers - pcfg.moe.first_k_dense if pcfg.moe else 0
    return {"init": lm_params_from_reference(pcfg, _np(params)), "loss": float(loss),
            "aux": float(metrics["aux"]), "grads": lm_params_from_reference(pcfg, _np(grads)),
            "ids": [torch.from_numpy(np.array(i)) for i in ids[:n_moe]]}


#: the reference's cases, one subprocess a group of archs: each jits its
#: cases while the others do and while the port's own tests run
REF_GROUPS = (("phi35_moe_42b", "seamless_m4t_medium"), ("deepseek_v2_lite_16b", "llava_next_34b"),
              ("zamba2_2p7b", "falcon_mamba_7b"))

_REFERENCE_CASES = """
import sys, torch
sys.path.insert(0, {tests!r})
import test_torch_train_families as T
out = {{}}
for arch in {archs!r}:
    for dtype in ("float32", "bfloat16"):
        out[arch, dtype, False] = T._ref_case(arch, dtype, False)
    if arch in T.MOE_ARCHS:
        out[arch, "float32", True] = T._ref_case(arch, "float32", True)
torch.save(out, {out!r})
"""


@pytest.fixture(scope="module", autouse=True)
def ref_cases(tmp_path_factory):
    """(arch, dtype, local) -> the reference's case (``_ref_case``), each
    jitted once, in the ``REF_GROUPS`` subprocesses that start with the
    module."""
    d = tmp_path_factory.mktemp("torch_train_families")
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for i, archs in enumerate(REF_GROUPS):
        script = _REFERENCE_CASES.format(tests=str(TESTS), archs=archs, out=str(d / f"{i}.pt"))
        procs[i] = subprocess.Popen([sys.executable, "-c", script], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cases = {}

    def get(arch, dtype, local=False):
        i = next(i for i, archs in enumerate(REF_GROUPS) if arch in archs)
        if i in procs:
            out, _ = procs[i].communicate(timeout=600)
            assert procs.pop(i).returncode == 0, out[-6000:]
            cases.update(torch.load(d / f"{i}.pt"))
        return cases[arch, dtype, local]

    try:
        yield get
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()


def _port_lm(cfg, state, perf=None):
    lm = plm.LM(cfg, q_block=Q_BLOCK, xent_chunks=XENT_CHUNKS, perf=perf, device="cpu")
    lm.load_state_dict(state)
    return lm


def _routed(lm, pinned=None):
    """A ``moe.route`` in the port that records each expert layer's ids (by
    the layer its router belongs to, so that the backward's recomputation
    finds its own) and, with ``pinned``, takes that layer's ids from it,
    gated by the port's own probabilities, renormalised."""
    layer = {id(p.moe["router"]): i for i, p in enumerate(getattr(lm, "blocks", []))
             if hasattr(p, "moe")}
    seen, route = {}, pmoe.route

    def hook(router_w, x, top_k):
        gates, idx, aux, z = route(router_w, x, top_k)
        i = layer[id(router_w)]
        if pinned is not None:
            idx = pinned[i]
            probs = torch.softmax(x.float() @ router_w.float(), dim=-1).gather(1, idx)
            gates = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
        seen.setdefault(i, idx)
        return gates, idx, aux, z

    return hook, seen


def _loss_and_grads(lm, batch, pinned=None):
    params = lm.trainable_params()
    hook, seen = _routed(lm, pinned)
    pmoe.route = hook
    try:
        loss, metrics = lm.loss(batch)
        loss.backward()
    finally:
        pmoe.route = _ROUTE
    return (loss.detach(), metrics["aux"].detach(),
            {k: p.grad.clone() for k, p in params.items()}, [seen[i] for i in sorted(seen)])


_ROUTE = pmoe.route


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b.float()) / torch.linalg.vector_norm(b.float()))


def _check(arch, dtype, got, want):
    loss, aux, grads, ids = got
    assert abs(loss.item() - want["loss"]) <= LOSS_TOL[dtype] * abs(want["loss"]), (
        loss.item(), want["loss"])
    assert abs(aux.item() - want["aux"]) <= LOSS_TOL[dtype] * max(abs(want["aux"]), 1.0)
    tol = BF16_TOL.get(arch, GRAD_TOL[dtype]) if dtype == "bfloat16" else GRAD_TOL[dtype]
    assert grads.keys() == want["grads"].keys()
    worst = max((_rel(grads[k], w), k) for k, w in want["grads"].items() if w.float().any())
    assert worst[0] <= tol, worst
    for k, w in want["grads"].items():
        if not w.float().any():
            assert not grads[k].float().any(), k
    return worst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_are_bitwise(arch, dtype):
    """No remat, "full" and "dots" (the optimized flags otherwise), from
    the port's own seeded weights."""
    rcfg, pcfg = _cfgs(arch, dtype)
    state = plm.LM(pcfg, device="cpu", seed=3).state_dict()
    batch = _batches(rcfg, pcfg)[1]
    runs = {pol: _loss_and_grads(_port_lm(pcfg, state, dataclasses.replace(
        plm.OPTIMIZED, remat_policy=pol)), batch) for pol in plm.REMAT_POLICIES}
    loss0, aux0, grads0, _ = runs["none"]
    for pol, (loss, aux, grads, _) in runs.items():
        assert torch.equal(loss, loss0) and torch.equal(aux, aux0), pol
        assert all(torch.equal(grads[k], grads0[k]) for k in grads0), pol


def _scan_inputs(T, seed, Bn=2, Di=6, N=4):
    """tests/test_torch_ssm.py's ranges: x, B, C normal; dt in [0.01, 0.2];
    A in [-2, -0.5]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bn, T, Di)), rng.uniform(0.01, 0.2, (Bn, T, Di)),
            -rng.uniform(0.5, 2.0, (Di, N)), rng.standard_normal((Bn, T, N)),
            rng.standard_normal((Bn, T, N)))


def _recurrence(x, dt, A, Bm, Cm):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = h_t . C_t, one step at
    a time, in the inputs' dtype (float64 here), differentiable."""
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(x.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None]
        ys.append((h * Cm[:, t, None]).sum(-1))
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("T,chunk", [(16, 4), (13, 5), (130, 128)])
def test_mamba1_training_scan(T, chunk):
    """The training form against the serving form (bitwise) and the float64
    recurrence: y, the final state and the gradients of a fixed weighting of
    both with respect to every input."""
    inputs = _scan_inputs(T, 1)
    rng = np.random.default_rng(2)
    wy, wh = (torch.from_numpy(rng.standard_normal(s)) for s in
              ((inputs[0].shape[0], T, inputs[0].shape[2]), (inputs[0].shape[0],
                                                            *inputs[2].shape)))
    f32 = [torch.from_numpy(a.astype(np.float32)).requires_grad_() for a in inputs]
    f64 = [torch.from_numpy(a).requires_grad_() for a in inputs]
    with torch.no_grad():
        y_serve, h_serve = ssm.selective_scan(*f32, chunk=chunk)
    y, h = ssm.selective_scan(*f32, chunk=chunk)
    assert torch.equal(y, y_serve) and torch.equal(h, h_serve)
    ((y.double() * wy).sum() + (h.double() * wh).sum()).backward()
    y64, h64 = _recurrence(*f64)
    ((y64 * wy).sum() + (h64 * wh).sum()).backward()
    torch.testing.assert_close(y.double(), y64.detach(), rtol=SCAN_TOL, atol=SCAN_TOL)
    torch.testing.assert_close(h.double(), h64.detach(), rtol=SCAN_TOL, atol=SCAN_TOL)
    for a, b in zip(f32, f64):
        assert _rel(a.grad.double(), b.grad) <= SCAN_TOL


@pytest.mark.parametrize("wants_grad", [False, True])
def test_selective_scan_form_follows_the_gradient(wants_grad, monkeypatch):
    """Grad mode alone (the default) keeps the serving form, which a
    serving LM's scan and the card's scan check run; the training form is
    taken only where an input requires a gradient."""
    calls = []
    real = ssm._scan_chunk
    monkeypatch.setattr(ssm, "_scan_chunk", lambda *a: calls.append(1) or real(*a))
    inputs = [torch.from_numpy(a.astype(np.float32)) for a in _scan_inputs(13, 1)]
    if wants_grad:
        inputs[2].requires_grad_()
    assert torch.is_grad_enabled()
    ssm.selective_scan(*inputs, chunk=5)
    assert bool(calls) == wants_grad


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_and_pretrain_twin(arch, tmp_path, monkeypatch):
    from repro_torch.examples import lm_pretrain
    from repro_torch.launch import train

    hist = train.main(["--arch", arch, "--preset", "smoke", "--steps", "2", "--seq", "16",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path / "cli")])
    assert [h["step"] for h in hist] == [0, 1] and all(np.isfinite(h["loss"]) for h in hist)
    monkeypatch.setitem(lm_pretrain.PRESETS, "10m", dict(
        n_layers=4, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128, head_dim=8,
        seq=16, batch=2))
    hist = lm_pretrain.main(["--arch", arch, "--steps", "2", "--device", "cpu", "--ckpt-dir",
                             str(tmp_path / "pretrain")])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref_cases, arch, dtype):
    want = ref_cases(arch, dtype)
    rcfg, pcfg = _cfgs(arch, dtype)
    pinned = want["ids"] if (dtype == "bfloat16" and arch in MOE_ARCHS) else None
    got = _loss_and_grads(_port_lm(pcfg, want["init"]), _batches(rcfg, pcfg)[1], pinned)
    _check(arch, dtype, got, want)
    if arch in MOE_ARCHS:
        assert len(got[3]) == len(want["ids"]) == pcfg.n_layers - pcfg.moe.first_k_dense
        assert all(torch.equal(a, b) for a, b in zip(got[3], want["ids"]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_local_mode_matches_reference(ref_cases, arch):
    """``LM.local()``: the experts through ``moe_apply_dense``, as the
    reference's local-mode LM (its int8 Trainer's), fp32."""
    want = ref_cases(arch, "float32", local=True)
    rcfg, pcfg = _cfgs(arch, "float32")
    lm = _port_lm(pcfg, want["init"])
    local = lm.local()
    assert local.local_mode and not lm.local_mode and local.embed is lm.embed
    got = _loss_and_grads(local, _batches(rcfg, pcfg)[1])
    _check(arch, "float32", got, want)
    # nothing is dropped at the smoke capacity, so the two dispatches agree
    cap = _loss_and_grads(_port_lm(pcfg, want["init"]), _batches(rcfg, pcfg)[1])
    assert abs(cap[0].item() - got[0].item()) <= 1e-5 * abs(got[0].item())


def test_audio_cross_attention_trains_causal(ref_cases, monkeypatch):
    """The reference's training cross-attention is causal (decoder position
    i sees frames 0 .. i); the port's matches it, and the same model with a
    non-causal cross-attention (serving's) is far from it."""
    arch = "seamless_m4t_medium"
    want = ref_cases(arch, "float32")
    rcfg, pcfg = _cfgs(arch, "float32")
    batch = _batches(rcfg, pcfg)[1]
    lm = _port_lm(pcfg, want["init"])
    with torch.no_grad():
        causal = lm.loss(batch)[0].item()
    real = plm.attn.blockwise_attention

    def open_cross(q, k, v, *, causal, **kw):  # the decoder's cross: Skv = FRAMES
        return real(q, k, v, causal=causal and k.shape[1] != FRAMES, **kw)

    monkeypatch.setattr(plm.attn, "blockwise_attention", open_cross)
    with torch.no_grad():
        non_causal = lm.loss(batch)[0].item()
    assert abs(causal - want["loss"]) <= LOSS_TOL["float32"] * want["loss"]
    assert abs(non_causal - want["loss"]) > 1e3 * LOSS_TOL["float32"] * want["loss"], (
        causal, non_causal, want["loss"])
