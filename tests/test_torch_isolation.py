"""The port stands alone and runs on the card unless asked otherwise: its
modules import neither jax nor the reference package, its mesh, its LM and
its CLIs (``serve_lm``, ``python -m repro_torch.serve``, the example twins
and the plan audit) default to CUDA and raise without a card, and its
config maps the reference's.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"


def _port_modules() -> tuple[str, ...]:
    """Every module of the port, found by walking the package, so that each
    new module is held to the rule too."""
    import repro_torch

    return ("repro_torch",) + tuple(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_reference():
    modules = _port_modules()
    for want in ("repro_torch.robustness.runner", "repro_torch.kernels.transpose.ops",
                 "repro_torch.kernels.flash.ops", "repro_torch.launch.serve_lm",
                 "repro_torch.configs.glm4_9b", "repro_torch.serve.engine",
                 "repro_torch.serve.__main__", "repro_torch.launch.serve",
                 "repro_torch.analysis.planlint", "repro_torch.examples.quickstart",
                 "repro_torch.examples.poisson", "repro_torch.examples.navier_stokes",
                 "repro_torch.optim.adamw", "repro_torch.optim.compress",
                 "repro_torch.data.pipeline", "repro_torch.data.prng",
                 "repro_torch.checkpoint.store", "repro_torch.runtime.trainer",
                 "repro_torch.launch.train", "repro_torch.examples.lm_pretrain"):
        assert want in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_make_mesh_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core.meshutil import make_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh((1, 1), ("p0", "p1"))


def test_kernel_wrappers_refuse_non_cuda_tensors():
    from repro_torch.kernels.exchange import kernel as xkernel
    from repro_torch.kernels.fft import kernel as fkernel
    from repro_torch.kernels.flash import kernel as flkernel
    from repro_torch.kernels.transpose import kernel as tkernel

    with pytest.raises(ValueError):
        fkernel.fourstep(torch.zeros(2, 8, dtype=torch.complex64), 8, 1)
    with pytest.raises(ValueError):
        xkernel.encode(torch.zeros(8, dtype=torch.complex64), 1, 1, 1, 8, codec="bf16",
                       layout=xkernel.CHUNK_MAJOR, guard=True)
    with pytest.raises(ValueError):
        tkernel.transpose01(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        flkernel.flash_attention(*(torch.zeros(1, 8, 2, 16),) * 3, causal=True)


def test_serving_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch import configs
    from repro_torch.launch import serve_lm
    from repro_torch.models.lm import LM

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--arch", "glm4_9b", "--preset", "smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(configs.smoke("glm4_9b"))


def test_spectral_server_cli_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.serve import __main__ as serve_cli

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--shapes", "16,16,16", "--requests", "2"])


def test_spectral_server_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.serve --device cpu`` serves every request on a
    one-rank gloo group it starts itself."""
    env = dict(os.environ, PYTHONPATH=str(SRC), HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
                           "--shapes", "16,16,16", "--requests", "6"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert '"unresolved": 0' in proc.stdout
    assert '"ok": 6' in proc.stdout


#: the example twins' and the plan audit's CLIs, with arguments that keep a
#: one-rank CPU run to seconds
_CLIS = {
    "repro_torch.examples.quickstart": [],
    "repro_torch.examples.poisson": ["--shape", "16,16,16"],
    "repro_torch.examples.navier_stokes": ["--n", "16", "--steps", "2"],
    "repro_torch.analysis.planlint": ["--only", "quickstart,navier_stokes[batched]"],
}


@pytest.mark.parametrize("module", list(_CLIS))
def test_example_and_audit_clis_default_to_cuda_and_raise_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(module).main(_CLIS[module])


@pytest.mark.parametrize("module", list(_CLIS))
def test_example_and_audit_clis_on_the_cpu(module, tmp_path):
    """``python -m <module> --device cpu`` runs on a one-rank gloo group it
    starts itself and exits 0 with its checks held."""
    env = dict(os.environ, PYTHONPATH=str(SRC), HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", module, "--device", "cpu", *_CLIS[module]],
                          env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert ("[ok]" if module.endswith("planlint") else "ok") in proc.stdout


#: the training CLIs, with arguments that keep a one-rank CPU run to seconds
_TRAIN_CLIS = {
    "repro_torch.launch.train": ["--arch", "glm4_9b", "--preset", "smoke", "--steps", "2"],
    "repro_torch.examples.lm_pretrain": ["--steps", "1"],
}


@pytest.mark.parametrize("module", list(_TRAIN_CLIS))
def test_training_clis_default_to_cuda_and_raise_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    with pytest.raises(RuntimeError, match="CUDA"):
        importlib.import_module(module).main([*_TRAIN_CLIS[module], "--ckpt-dir",
                                              str(tmp_path)])
    assert not any(tmp_path.iterdir())  # nothing ran on the CPU instead


def test_train_cli_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains on the CPU
    and writes its final checkpoint."""
    env = dict(os.environ, PYTHONPATH=str(SRC), HOME=str(tmp_path), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")  # the suite's workers share the cores
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
                           *_TRAIN_CLIS["repro_torch.launch.train"]], env=env,
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "trained 2 steps" in proc.stdout
    assert (tmp_path / "repro_torch_train_glm4_9b" / "step_0000000002").is_dir()


@pytest.mark.parametrize("fields,expect", [
    ({}, {"impl": "torch", "exchange_impl": "torch"}),
    ({"impl": "matmul", "exchange_impl": "pallas", "comm_dtype": "bf16"},
     {"impl": "matmul", "exchange_impl": "cuda", "comm_dtype": "bf16"}),
    ({"method": "traditional", "comm_dtype": "int8", "guard": "strict"},
     {"method": "traditional", "comm_dtype": "int8", "guard": "strict", "exchange_impl": "torch"}),
])
def test_config_from_reference(fields, expect):
    from repro.core.planconfig import PlanConfig as RefConfig
    from repro_torch.core.planconfig import PlanConfig, config_from_reference

    ref = RefConfig(**fields)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert isinstance(cfg, PlanConfig)
    for k, v in expect.items():
        assert getattr(cfg, k) == v
    assert (cfg.chunks, cfg.batch_fusion, cfg.tuner_cache) == (ref.chunks, ref.batch_fusion,
                                                               ref.tuner_cache)


def test_port_vocabulary():
    from repro_torch.core.planconfig import PlanConfig

    for bad in ({"impl": "jnp"}, {"exchange_impl": "pallas"}, {"method": "bogus"},
                {"guard": "maybe"}, {"chunks": 0}, {"comm_dtype": "fp8"}):
        with pytest.raises(ValueError):
            PlanConfig(**bad)
    assert PlanConfig(comm_dtype="bfloat16").stage_entry() == ("fused", 1, "bf16", "torch",
                                                               "stacked")


def test_auto_method_names_the_tuner(monkeypatch):
    """``method="auto"`` builds (it raised before the tuner was ported), and
    its schedules come from the tuner, with the plan's cache path and field
    count."""
    from repro_torch.core import tuner
    from repro_torch.core.pfft import ParallelFFT
    from repro_torch.core.planconfig import PlanConfig, StageEntry

    class Mesh:  # the attributes a plan's arithmetic reads
        device_type, shape, mesh_dim_names = "cpu", (1, 1), ("p0", "p1")

        def size(self, dim=None):
            return 1

    asked = []

    def tuned(plan, *, cache_path=None, nfields=1):
        asked.append((cache_path, nfields))
        fusion = "per-field" if nfields > 1 else "stacked"
        return (StageEntry("traditional", 1, "complex64", "torch", fusion),) * 2

    monkeypatch.setattr(tuner, "get_or_tune", tuned)
    plan = ParallelFFT(Mesh(), (4, 4, 4), ("p0", "p1"),
                       config=PlanConfig(method="auto", tuner_cache="t.json"))
    assert plan.schedule == (StageEntry("traditional", 1, "complex64"),) * 2
    assert plan.batched_schedule(3)[0].batch_fusion == "per-field"
    assert asked == [("t.json", 1), ("t.json", 3)]
