"""The quality-suite tool's command line (tools/quality_suite.py::main)
end to end on the CPU at a tiny size: the fit, one v1 frame from the
fitted decoder, the CSS net and the weak net. Fitted and trained nets go
under --nets-out and nowhere else, the JAX package's loaders read them,
and the committed data/quality_nets/ is refused as --nets-out and left
byte-identical (its files hashed before and after)."""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.models import deepsdf as jdsdf
from sdflabel_tpu.pipelines import train_css as jtrain_pipe
from sdflabel_tpu_torch.tools import quality_suite as qs
from torch_parity_util import few_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(REPO, "data", "quality_nets")
TINY = ["--frames", "1", "--fit-steps", "2", "--css-steps", "1",
        "--css-width", "8", "--weak-steps", "1", "--device", "cpu"]


def _hashes():
    out = {}
    for name in sorted(os.listdir(COMMITTED)):
        with open(os.path.join(COMMITTED, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_tiny_run_writes_nets_only_under_nets_out(tmp_path, monkeypatch):
    before = _hashes()
    monkeypatch.chdir(tmp_path)  # a stray relative write would land here
    meta, seconds = qs.main(TINY + ["--out", "suite", "--nets-out",
                                    "nets"])
    assert _hashes() == before
    assert sorted(os.listdir(tmp_path)) == ["nets", "suite"]
    assert _files(tmp_path / "nets") == [
        "css_quality.msgpack", "css_quality_weak.msgpack",
        "deepsdf_quality.json", "deepsdf_quality.pt"]
    assert _files(tmp_path / "suite") == [
        "mv3d_kitti_split/trainval.txt", "suite_meta.json",
        "training/calib/000000.txt", "training/image_2/000000.png",
        "training/label_2/000000.txt", "training/velodyne/000000.bin"]
    with open(tmp_path / "suite" / "suite_meta.json") as f:
        assert json.load(f) == meta
    assert meta["profile"] == "v1" and meta["frames"] == 1
    assert meta["css_width"] == 8
    assert meta["weak_css"] == "css_quality_weak.msgpack"
    assert set(seconds) == {"fit", "frames", "css", "css_weak"}
    # the JAX package's loaders read every net
    cfg, params = jdsdf.load_torch_checkpoint(
        str(tmp_path / "nets" / "deepsdf_quality.pt"))
    assert tuple(cfg.dims) == (96, 96, 96)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(params))
    # the template's shapes, without running flax's initializers
    template = jax.eval_shape(lambda: jcss.CSSNet(
        use_running_average=False, width=8).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3, 128, 128))))
    for name in ("css_quality.msgpack", "css_quality_weak.msgpack"):
        loaded = jtrain_pipe.load_checkpoint(
            str(tmp_path / "nets" / name), template)
        assert jax.tree.structure(loaded) == jax.tree.structure(template)
        for got, want in zip(jax.tree.leaves(loaded),
                             jax.tree.leaves(template)):
            assert got.shape == want.shape and got.dtype == want.dtype
            assert np.isfinite(got).all()


@pytest.mark.parametrize("where", ["absolute", "inside", "relative",
                                   "link"])
def test_committed_nets_refused(tmp_path, monkeypatch, where):
    before = _hashes()
    if where == "relative":
        monkeypatch.chdir(REPO)
        target = os.path.join("data", "quality_nets")
    elif where == "link":
        target = str(tmp_path / "nets")
        os.symlink(COMMITTED, target)
    else:
        target = COMMITTED if where == "absolute" else os.path.join(
            COMMITTED, "sub")
    with pytest.raises(ValueError, match="never written"):
        qs.main(TINY + ["--out", str(tmp_path / "suite"), "--nets-out",
                        target])
    assert _hashes() == before
    assert not os.path.exists(tmp_path / "suite")
