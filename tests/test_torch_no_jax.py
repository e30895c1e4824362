"""sdflabel_tpu_torch and chip_smoke.py import nothing of JAX, flax, optax,
msgpack, PIL, cv2, sdflabel_tpu or scripts/: every module imports in a
process where those are blocked."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "cv2",
           "sdflabel_tpu", "scripts", "make_quality_suite",
           "run_quality_benchmark", "make_demo_assets")

_SCRIPT = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {REPO!r})
import sdflabel_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sdflabel_tpu_torch.__path__, "sdflabel_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
print(" ".join(names))
"""
# the modules of each slice, so that a module that stops being found fails
EXPECTED = tuple("sdflabel_tpu_torch." + m for m in (
    "ops.mlp2_cuda",
    "ops.rotated_iou",
    "eval.constants",
    "eval.native",
    "eval.detection3d",
    "pipelines.evaluate_dump",
    "tools.quality_suite",
    "tools.demo_assets",
    "main",
    "data.kitti",
    "ops.splat_cuda",
    "pipelines.train_css",
    "parallel.batched_refine",
    "utils.viz",
    "utils.viz3d",
    "ops.pnp",
    "data.sdf_samples",
    "models.deepsdf_workspace",
    "engine.deepsdf_train",
    "pipelines.train_deepsdf",
    "models.css_fused",
    "parallel.mesh",
    "parallel.rays",
    "parallel.sharded_refine",
    "pipelines.render_demo",
    "utils.meshio",
    "utils.profiling",
))


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = out.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 30 and set(EXPECTED) <= set(names), names


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
