"""The demo-asset tool's command line (tools/demo_assets.py::main) end
to end on the CPU at a tiny size (2 fit steps, 1 CSS step), in a process
where JAX and the JAX package cannot be imported: everything is written
under --out and nowhere else, the JAX package's and the port's loaders
read it, and the committed data/optimization/ and configs/ are refused as
--out in each spelling and left byte-identical (their files hashed before
and after)."""

import configparser
import hashlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.models import deepsdf as jdsdf
from sdflabel_tpu.pipelines import train_css as jtrain_pipe
from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.models import deepsdf as tdsdf
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from sdflabel_tpu_torch.tools import demo_assets as da
from test_torch_no_jax import BLOCKED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = [os.path.join(REPO, "data", "optimization"),
             os.path.join(REPO, "configs")]
TINY = ["--fit-steps", "2", "--css-steps", "1", "--device", "cpu"]
FILES = ["config_demo.ini", "css_demo.msgpack", "deepsdf_demo.json",
         "deepsdf_demo.pt", "kitti_sample.npz", "maskrcnn.npz"]

_RUN = f"""
import runpy, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it raises ImportError
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(2)
sys.argv = ["demo_assets"] + sys.argv[1:]
runpy.run_module("sdflabel_tpu_torch.tools.demo_assets", run_name="__main__")
loaded = [m for m in sys.modules
          if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None]
assert not loaded, loaded
"""


def _hashes():
    out = {}
    for root in COMMITTED:
        for name in sorted(os.listdir(root)):
            with open(os.path.join(root, name), "rb") as f:
                out[os.path.join(root, name)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


def test_tiny_run_writes_only_under_out(tmp_path):
    before = _hashes()
    env = dict(os.environ, PYTHONPATH="")
    # a stray relative write would land in the working directory
    out = subprocess.run([sys.executable, "-c", _RUN, "--out", "assets"]
                         + TINY, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "seconds" in out.stdout and '"css"' in out.stdout
    assert _hashes() == before
    assert os.listdir(tmp_path) == ["assets"]
    assets = tmp_path / "assets"
    assert sorted(os.listdir(assets)) == FILES

    # the config points into --out, relative to the working directory
    cfgp = configparser.ConfigParser()
    cfgp.read(assets / "config_demo.ini")
    cfg = cfg_mod.RefineCfg.from_ini(cfgp)
    assert cfg.css_path == os.path.join("assets", "css_demo.msgpack")
    assert cfg.deepsdf_path == os.path.join("assets", "deepsdf_demo.pt")
    assert cfg.css_width == da.CSS_WIDTH and cfg.iters == 60

    # the port's loaders
    sample = tpipe.load_demo_sample(str(assets))
    anno = sample["gt"][0]
    assert sample["annos"]["easy"] == [anno]
    assert anno["bbox"][2] > anno["bbox"][0] and len(sample["lidar"]) > 7500
    maskrcnn = tpipe.load_demo_maskrcnn(str(assets))
    l, t_, r, b = maskrcnn["bboxes"][0].astype(int)
    assert maskrcnn["masks"][0].shape == (b - t_, r - l)
    model = tcss.load_css(str(assets / "css_demo.msgpack"), da.CSS_WIDTH,
                          device="cpu")
    assert all(np.isfinite(v.numpy()).all()
               for v in model.state_dict().values())
    dcfg, dparams = tdsdf.load_torch_checkpoint(
        str(assets / "deepsdf_demo.pt"), device="cpu")
    assert tuple(dcfg.dims) == (64, 64, 64)

    # the JAX package's
    jcfg, jparams = jdsdf.load_torch_checkpoint(
        str(assets / "deepsdf_demo.pt"))
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), dparams))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(got) == len(want)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    template = jax.eval_shape(lambda: jcss.CSSNet(
        use_running_average=False, width=da.CSS_WIDTH).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 128, 128))))
    loaded = jtrain_pipe.load_checkpoint(str(assets / "css_demo.msgpack"),
                                         template)
    assert jax.tree.structure(loaded) == jax.tree.structure(template)
    for g, w in zip(jax.tree.leaves(loaded), jax.tree.leaves(template)):
        assert g.shape == w.shape and np.isfinite(g).all()


@pytest.mark.parametrize("where", ["absolute", "inside", "relative",
                                   "link", "configs", "configs_relative"])
def test_committed_directories_refused(tmp_path, monkeypatch, where):
    before = _hashes()
    target = {"absolute": COMMITTED[0],
              "inside": os.path.join(COMMITTED[0], "sub"),
              "configs": COMMITTED[1]}.get(where)
    if where in ("relative", "configs_relative"):
        monkeypatch.chdir(REPO)
        target = (os.path.join("data", "optimization")
                  if where == "relative" else "configs")
    elif where == "link":
        target = str(tmp_path / "assets")
        os.symlink(COMMITTED[0], target)
    with pytest.raises(ValueError, match="never written"):
        da.main(["--out", target] + TINY)
    assert _hashes() == before
