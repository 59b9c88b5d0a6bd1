"""paddle_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points default to the CUDA card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"


def test_import_leaves_jax_and_paddle_tpu_unloaded():
    mods = sorted(
        "paddle_tpu_torch" + ("." + ".".join(p.relative_to(PKG).with_suffix(
            "").parts) if p.name != "__init__.py" or p.parent != PKG else "")
        for p in PKG.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print('LOADED', len(sys.modules))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED" in r.stdout
    assert len(mods) >= 15
    # the trainer runtime's modules and the training API's are among them
    assert set(RUNTIME_MODULES) <= set(mods)
    assert set(TRAINING_API_MODULES) <= set(mods)


RUNTIME_MODULES = (
    "paddle_tpu_torch.checkpoint", "paddle_tpu_torch.resilience",
    "paddle_tpu_torch.resilience.anomaly",
    "paddle_tpu_torch.resilience.preemption",
    "paddle_tpu_torch.resilience.checkpoint_manager",
    "paddle_tpu_torch.resilience.reshard", "paddle_tpu_torch.io",
    "paddle_tpu_torch.io.dataset", "paddle_tpu_torch.io.sampler",
    "paddle_tpu_torch.io.dataloader", "paddle_tpu_torch.optimizer.lr",
    "paddle_tpu_torch.distributed.watchdog",
    "paddle_tpu_torch.testing.chaos", "paddle_tpu_torch.testing._chaos_train",
    "paddle_tpu_torch.trainer.trainer")


TRAINING_API_MODULES = (
    "paddle_tpu_torch.optimizer.optimizer", "paddle_tpu_torch.optimizer.lbfgs",
    "paddle_tpu_torch.regularizer", "paddle_tpu_torch.amp",
    "paddle_tpu_torch.amp.auto_cast", "paddle_tpu_torch.amp.grad_scaler",
    "paddle_tpu_torch.amp.debugging", "paddle_tpu_torch.nn.clip",
    "paddle_tpu_torch.incubate", "paddle_tpu_torch.incubate.extras",
    "paddle_tpu_torch.incubate.optimizer",
    "paddle_tpu_torch.incubate.optimizer.functional")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_paddle_tpu(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_model_defaults_to_the_card():
    from paddle_tpu_torch.device import default_device
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    if torch.cuda.is_available():
        m = LlamaForCausalLM(cfg)
        assert m.lm_head.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_device()


def test_runtime_entry_points_default_to_the_card(tmp_path):
    """The DataLoader's device prefetch and the chaos training script run
    on the card unless asked for the CPU, and raise without one."""
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    from paddle_tpu_torch.testing import _chaos_train
    ds = TensorDataset([torch.zeros(4, 2).numpy()])
    if torch.cuda.is_available():
        assert DataLoader(ds, prefetch_to_device=True).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DataLoader(ds, prefetch_to_device=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _chaos_train.main(["--ckpt-dir", str(tmp_path), "--steps", "1"])


DISTRIBUTED_MODULES = (
    "paddle_tpu_torch.distributed.communication",
    "paddle_tpu_torch.distributed.collective",
    "paddle_tpu_torch.distributed.parallel",
    "paddle_tpu_torch.distributed.topology",
    "paddle_tpu_torch.distributed.sharding",
    "paddle_tpu_torch.distributed.strategy",
    "paddle_tpu_torch.distributed.fleet",
    "paddle_tpu_torch.distributed.fleet.base.topology",
    "paddle_tpu_torch.distributed.fleet.utils.sequence_parallel_utils",
    "paddle_tpu_torch.distributed.fleet.meta_parallel",
    "paddle_tpu_torch.distributed.fleet.meta_parallel.wrappers",
    "paddle_tpu_torch.parallel.mesh", "paddle_tpu_torch.parallel.api",
    "paddle_tpu_torch.parallel.reshard", "paddle_tpu_torch.parallel.mp_layers",
    "paddle_tpu_torch.parallel.ring_attention",
    "paddle_tpu_torch.parallel.ulysses")


@pytest.mark.parametrize("mod", DISTRIBUTED_MODULES)
def test_distributed_modules_import_alone_without_jax(mod):
    """Each module of the mesh slice imports on its own (no import cycle
    through the lazily loaded ``distributed`` package) and loads neither
    JAX nor the JAX package."""
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]\nassert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def test_parallel_env_defaults_to_nccl_on_the_card():
    """init_parallel_env asks for NCCL on the card unless told otherwise;
    without a card it raises rather than falling back to gloo."""
    import inspect
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    sig = inspect.signature(init_parallel_env).parameters
    assert sig["backend"].default == "nccl"
    assert sig["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    code = ("from paddle_tpu_torch.parallel.mesh import init_parallel_env\n"
            "import torch.distributed as dist\n"
            "try:\n    init_parallel_env()\nexcept Exception as e:\n"
            "    assert not dist.is_initialized(), 'fell back'\n"
            "    print('REFUSED', type(e).__name__)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "REFUSED" in r.stdout, r.stderr[-3000:]
