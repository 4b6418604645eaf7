"""Guards of the PyTorch port: it imports no JAX, flax or JAX-package code,
and its entry points never drop to the CPU on their own."""

import ast
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
             "bevrender_tpu", "PIL")
# the modules of the training slice, each checked by name so that a moved
# or missing one is noticed
TRAINING_MODULES = (
    "losses/rendering.py", "losses/metric.py", "losses/recall.py",
    "training/schedule.py", "training/metrics.py", "training/checkpoint.py",
    "training/trainer.py", "data/prefetch.py", "convert.py", "config.py",
    "ops/kernels/lattice_bias_bwd.py", "ops/kernels/fused_site_bwd.py",
)


# the modules the pyramid slice changed: stage transitions, the transposed
# conv and its bridge, the bias route and the wide kernels' wrappers
PYRAMID_MODULES = (
    "models/encoder.py", "models/layers.py", "models/backbone.py",
    "ops/deform_attn.py", "ops/kernels/lattice_bias.py",
    "ops/kernels/_launch.py", "ops/kernels/build.py",
)


# the modules the wide-table route added or changed that the lists above do
# not name: the wide site's wrappers, the counters, and the plumbing of the
# route fields to every site
WIDE_ROUTE_MODULES = (
    "ops/kernels/fused_site_wide.py", "ops/kernels/__init__.py",
    "models/attention.py", "inference/register.py",
)


# the folded fused sites' wrappers (the other modules this slice changed
# are named above)
FOLD_MODULES = ("ops/kernels/fused_site_fold.py",)


# the window kernels' wrappers (the windowed bias itself is in
# ops/deform_attn.py, and its config field in config.py, named above)
WINDOWS_MODULES = ("ops/kernels/lattice_windows.py",)


# the retrieval head, and the model that wires it in with streaming serving
# (the pipeline and the trainer that use them are named above)
RETRIEVAL_MODULES = ("models/retrieval.py", "models/bevrender.py")


# the host data feed and the training CLI (config.py and data/prefetch.py
# are named above): PNG, resize and preprocessing without PIL, the
# processor, the dataset, the map loader, the gray mask's geometry
DATA_MODULES = (
    "data/processor.py", "data/native.py", "data/png.py", "data/dataset.py",
    "data/maploader.py", "data/preprocess.py", "geometry/projection.py",
    "train.py",
)


# the utilities, the captured training step, and the decoder that holds
# SimpleDecoder (ResnetFPN is in models/backbone.py, named above); the
# bridge from Orbax checkpoints is a script under scripts/, not a module of
# the port, and imports the JAX package by design
UTILS_GRAPH_MODULES = (
    "utils/__init__.py", "utils/profiling.py", "utils/timing.py",
    "training/graph_step.py", "models/decoder.py",
)


# the data-parallel layer (the modules it threads through are named above;
# the package's __init__ imports nothing)
PARALLEL_MODULES = ("parallel/dist.py",)


# the model axis and the reference API: the losses package, which now
# exports the reference API's loss classes (the model axis threads through
# parallel/dist.py, models/attention.py, models/layers.py and the
# projector's geometry/projection.py, named above)
MODEL_AXIS_MODULES = ("losses/__init__.py",)


def _port_files():
    return sorted((ROOT / "bevrender_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              in ("__import__",) and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [
        (f.relative_to(ROOT).as_posix(), name)
        for f in files for name in _imported(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


@pytest.mark.parametrize("module", TRAINING_MODULES + PYRAMID_MODULES
                         + WIDE_ROUTE_MODULES + FOLD_MODULES
                         + WINDOWS_MODULES + RETRIEVAL_MODULES
                         + DATA_MODULES + UTILS_GRAPH_MODULES
                         + PARALLEL_MODULES + MODEL_AXIS_MODULES)
def test_training_module_imports_no_jax(module):
    path = ROOT / "bevrender_tpu_torch" / module
    assert path.exists()
    names = list(_imported(path))
    assert names, module
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]
    # the optional package (wandb) is imported inside the functions that
    # need it, never at module level
    tree = ast.parse(path.read_text())
    top = [a.name for node in tree.body if isinstance(node, ast.Import)
           for a in node.names] + [node.module for node in tree.body
                                   if isinstance(node, ast.ImportFrom)]
    assert not [n for n in top if n.split(".")[0] in ("wandb", "PIL")]


def test_port_reads_no_environment_knobs():
    """Kernel choice lives in the config. The environment variables the
    port reads are CUDA_HOME, to find nvcc, and the ones torchrun sets for
    each rank (``parallel.dist.initialize_distributed``)."""
    hits = []
    for f in _port_files():
        text = f.read_text()
        if "os.environ" in text or "getenv(" in text:
            hits.append(f.relative_to(ROOT).as_posix())
    assert hits == ["bevrender_tpu_torch/ops/kernels/build.py",
                    "bevrender_tpu_torch/parallel/dist.py"]
    for hit in hits:
        assert "BEVRENDER_" not in (ROOT / hit).read_text()
    read = set(re.findall(r"os\.environ(?:\.get)?[\[(]\"(\w+)\"",
                          (ROOT / hits[1]).read_text()))
    assert read == {"WORLD_SIZE", "RANK", "LOCAL_RANK"}


def test_scan_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom bevrender_tpu.ops import x\n"
                 "from bevrender_tpu_torch import y\n")
    assert list(_imported(p)) == ["jax.numpy", "bevrender_tpu.ops",
                                  "bevrender_tpu_torch"]


def test_pipeline_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from bevrender_tpu_torch import config
    from bevrender_tpu_torch.inference.register import RegistrationPipeline

    cfg = config.Config()
    cfg.model = config.tiny_model_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegistrationPipeline(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RegistrationPipeline(cfg, device="cuda")


def test_every_kernel_source_is_built_and_counted():
    """Each CUDA source is one library that ``build_all`` builds, and each
    kernel it holds has a launch counter."""
    from bevrender_tpu_torch.ops import kernels
    from bevrender_tpu_torch.ops.kernels import build

    csrc = ROOT / "bevrender_tpu_torch" / "ops" / "kernels" / "csrc"
    assert sorted(build.SOURCES) == sorted(p.stem for p in csrc.glob("*.cu"))
    names = set(kernels.counts())
    assert set(build.SOURCES) <= names
    assert names - set(build.SOURCES) == {"fused_site_lse",
                                          "fused_site_wide_lse",
                                          "fused_site_fold_heads_lse",
                                          "lattice_windows_bwd"}
