"""Helpers shared by the tests that hold sdflabel_tpu_torch against
sdflabel_tpu: both packages take the same numpy inputs."""

import fcntl
import os
import pickle
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


def jax_tree_to_numpy(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def jax_ransac_ranks(key, num_valid: int, num_hypotheses: int = 567,
                     sample_size: int = 4) -> np.ndarray:
    """The (H, S) ranks sdflabel_tpu.ops.ransac.ransac_pose draws from
    `key` (its draw_distinct, ransac.py:141-155) for `num_valid` valid
    scene points."""
    v = jnp.int32(num_valid)

    def draw_distinct(k):
        ks = jax.random.split(k, sample_size)
        chosen = []
        for j in range(sample_size):
            r = jax.random.randint(ks[j], (), 0, jnp.maximum(v - j, 1))
            if chosen:
                prev = jnp.sort(jnp.stack(chosen))
                for t in range(j):
                    r = r + (r >= prev[t])
            chosen.append(r)
        return jnp.stack(chosen)

    return np.array(jax.vmap(draw_distinct)(
        jax.random.split(key, num_hypotheses)))


class JaxRankSource:
    """Stands in for RefineRuntime.ransac_ranks: the ranks the JAX
    runtime draws, call after call (its key sequence from rng_seed)."""

    def __init__(self, rng_seed: int = 1, num_hypotheses: int = 567):
        self.key = jax.random.PRNGKey(rng_seed)
        self.num_hypotheses = num_hypotheses

    def __call__(self, num_valid: int):
        import torch

        self.key, sub = jax.random.split(self.key)
        return torch.as_tensor(jax_ransac_ranks(sub, num_valid,
                                                self.num_hypotheses))


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_TREES = {"v1": "quality_suite", "v2": "quality_suite_v2"}


def script_module(name: str):
    """scripts/<name>.py as a module."""
    import importlib

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))


def make_quality_suite_module():
    """scripts/make_quality_suite.py as a module."""
    return script_module("make_quality_suite")


DEMO = os.path.join(REPO, "data", "optimization")


def committed_demo_scene():
    """The committed demo scene, which scripts/make_demo_assets.py wrote:
    (sample as load_demo_sample reads it, the annotation, the crop's NOCS
    (3, ch, cw) and mask (ch, cw)). The NOCS and mask are read back from
    the image: the mask where the image differs from the background noise
    the script drew first (np.random.RandomState(0)), the NOCS there as
    the pasted BGR pixels in RGB order, 0 elsewhere (the script's CSS
    targets zero the NOCS off the mask)."""
    import json

    data = np.load(os.path.join(DEMO, "kitti_sample.npz"))
    sample = {k: data[k] for k in
              ("image", "depth", "orig_cam", "world_to_cam", "lidar")}
    anno = json.loads(str(data["annos_json"]))["gt"][0]
    h, w, _ = sample["image"].shape
    background = np.random.RandomState(0).uniform(
        0.25, 0.45, (h, w, 3)).astype(np.float32)
    l, t_, r, b = anno["bbox"]
    crop = sample["image"][t_:b, l:r]
    mask = (crop != background[t_:b, l:r]).any(-1)
    nocs = np.transpose(crop[..., ::-1] * mask[..., None], (2, 0, 1))
    return sample, anno, np.ascontiguousarray(nocs, np.float32), mask


def jax_quality_suite(work, profile: str, n_frames: int):
    """Run scripts/make_quality_suite.py --profile `profile` --frames
    `n_frames` --skip-fit --skip-css in the directory `work`, whose
    data/quality_nets links to the committed nets: the run only reads
    them (without --skip-fit or --skip-css it would write through the
    link). Returns the suite's directory and the frames its frame builder
    returned, as (name, annotations, full-frame NOCS, mask) tuples."""
    mqs = make_quality_suite_module()
    os.makedirs(os.path.join(work, "data"))
    os.symlink(os.path.join(REPO, "data", "quality_nets"),
               os.path.join(work, "data", "quality_nets"))
    built = []
    builders = {"v1": "build_frame", "v2": "build_frame_v2"}
    original = getattr(mqs, builders[profile])

    def spy(*args, **kw):
        out = original(*args, **kw)
        if out is not None:
            built.append(out)
        return out

    cwd, argv, tree = os.getcwd(), sys.argv, mqs.TREE
    try:
        os.chdir(work)
        setattr(mqs, builders[profile], spy)
        # main() points the module's TREE at the v2 tree and leaves it
        # there; v1 writes to the module's default
        mqs.TREE = os.path.join("data", QUALITY_TREES["v1"])
        sys.argv = ["make_quality_suite.py", "--profile", profile,
                    "--frames", str(n_frames), "--skip-fit", "--skip-css"]
        mqs.main()
    finally:
        os.chdir(cwd)
        sys.argv = argv
        mqs.TREE = tree
        setattr(mqs, builders[profile], original)
    frames = [(f"{i:06d}", out[2], out[3], out[4])
              for i, out in enumerate(built)]
    return os.path.join(work, "data", QUALITY_TREES[profile]), frames


def shared_jax_quality_suite(tmp_path_factory, profile: str, n_frames: int):
    """:func:`jax_quality_suite` made once a test session: the first test
    process to ask builds it in the session's shared temporary directory
    (under xdist the workers' common parent), the others wait for it and
    read it. Returns what jax_quality_suite returns."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    name = f"jax_quality_{profile}_{n_frames}"
    work, done = root / name, root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            if work.exists():
                shutil.rmtree(work)
            built = jax_quality_suite(str(work), profile, n_frames)
            with open(f"{done}.tmp", "wb") as f:
                pickle.dump(built, f)
            os.replace(f"{done}.tmp", done)
        with open(done, "rb") as f:
            return pickle.load(f)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """At most 2 torch threads in the module that imports this fixture:
    small CPU operators slow down many times over when the parallel test
    workers oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
