"""Nothing the harness, the references or the jobs load is the JAX stack
or the JAX package, compared by whole top-level names; the references
load nothing of the port."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

from portbench import common

PROBE = r"""
import json, sys
sys.path.insert(0, {root!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
from portbench import common
for name in {readers!r}:
    common.load_reader(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(mods, readers=()):
    code = PROBE.format(root=common.ROOT, mods=list(mods),
                        readers=list(readers))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_forbidden_compares_whole_names():
    assert common.forbidden_modules(["sdflabel_tpu_torch.ops", "jaxtyping",
                                     "numpy"]) == []
    assert common.forbidden_modules(["sdflabel_tpu.models", "jax.numpy",
                                     "flax.core"]) == ["flax", "jax",
                                                       "sdflabel_tpu"]


def test_harness_and_jobs_load_no_jax():
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    jobs = {common.load_json(os.path.join(
        common.HERE, "traffic", w["traffic"] + ".json"))["job"]
        for w in bench["workloads"]}
    mods = ["portbench.run", "portbench.control",
            *(f"portbench.jobs.{j}" for j in sorted(jobs))]
    # the jobs import the port inside set-up; load it too
    mods += ["sdflabel_tpu_torch.pipelines.refine_css",
             "sdflabel_tpu_torch.engine.deepsdf_train"]
    names = loaded(mods, [m["name"] for m in bench["per_layer"]])
    assert not names & set(common.FORBIDDEN)


def test_references_load_nothing_of_the_port():
    refs = [f"portbench.reference.{os.path.basename(p)[:-3]}"
            for p in glob.glob(os.path.join(common.HERE, "reference",
                                            "*.py"))
            if not p.endswith("__init__.py")]
    names = loaded(refs)
    assert not names & (set(common.FORBIDDEN) | {"sdflabel_tpu_torch"})


def test_no_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(common.HERE, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in common.FORBIDDEN, (path, n)
            if "reference" in path and names:
                assert all(n.split(".")[0] != "sdflabel_tpu_torch"
                           for n in names), (path, names)


def test_benchmark_alone_gives_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/ (no
    program), a run fails and prints no result line."""
    import shutil

    shutil.copy(os.path.join(common.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(common.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import run, common; "
            "from portbench.tests.conftest import Args; "
            "files = common.load_cell('refine_b4'); "
            "sys.exit(run.run(Args('refine_b4', 1, 1, 0), device='cpu', "
            "cell_files=files))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert "sdflabel_tpu_torch" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
