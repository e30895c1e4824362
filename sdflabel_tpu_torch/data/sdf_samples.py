"""SDF sample sets for DeepSDF decoder training, in numpy.

Counterpart of sdflabel_tpu/data/sdf_samples.py (the port keeps its own
copy: it imports nothing of the JAX package). The samples follow the
external DeepSDF trainer's on-disk convention: one ``<instance>.npz`` per
scene with ``pos``/``neg`` float arrays of ``(x, y, z, sdf)`` rows under
``SdfSamples/<dataset>/<class>/``. A :class:`ScenePack` holds every
scene's rows padded cyclically to one width, so that the train step
(engine/deepsdf_train.py) draws its half-positive, half-negative rows with
replacement on the card from fixed-shape tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

sdf_samples_subdir = "SdfSamples"


def write_sdf_samples(path: str, pos: np.ndarray, neg: np.ndarray) -> None:
    """Write one scene's samples in the external-trainer npz convention."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, pos=np.asarray(pos, np.float32),
             neg=np.asarray(neg, np.float32))


def read_sdf_samples(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read one scene -> (pos (N,4), neg (M,4)) float32 arrays."""
    with np.load(path) as data:
        pos = np.asarray(data["pos"], np.float32).reshape(-1, 4)
        neg = np.asarray(data["neg"], np.float32).reshape(-1, 4)
    return pos, neg


def split_instance_paths(data_source: str, split: dict) -> list[str]:
    """Resolve a DeepSDF split json ({dataset: {class: [instances]}}) to
    SdfSamples npz paths, in deterministic (sorted) order."""
    paths = []
    for dataset in sorted(split):
        for class_name in sorted(split[dataset]):
            for instance in sorted(split[dataset][class_name]):
                paths.append(os.path.join(
                    data_source, sdf_samples_subdir, dataset, class_name,
                    instance + ".npz"))
    return paths


def load_split_file(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class ScenePack:
    """Fixed-shape pack of every scene's samples, ready for device upload.

    pos / neg: (num_scenes, P, 4) float32, rows repeated cyclically up to
    the pad width (so with-replacement index sampling over [0, count) and
    over [0, P) draw from the same row population — padding never
    introduces rows that don't exist in the scene).
    pos_count / neg_count: (num_scenes,) int32 true row counts.
    scales: (num_scenes,) float32 optional per-scene metric scale targets
    for the decoder's scale head (NaN where unknown).
    names: instance identifiers (for checkpoints/logs).
    """

    pos: np.ndarray
    neg: np.ndarray
    pos_count: np.ndarray
    neg_count: np.ndarray
    scales: np.ndarray
    names: tuple[str, ...]

    @property
    def num_scenes(self) -> int:
        return len(self.names)


def _pad_cyclic(rows: np.ndarray, width: int) -> np.ndarray:
    n = len(rows)
    if n == 0:
        raise ValueError("scene has an empty sample set")
    reps = -(-width // n)
    return np.tile(rows, (reps, 1))[:width]


def pack_scenes(
    scene_samples: list[tuple[np.ndarray, np.ndarray]],
    names: list[str] | None = None,
    scales: list[float] | None = None,
) -> ScenePack:
    """Pack per-scene (pos, neg) arrays into one fixed-shape ScenePack.

    pos and neg get INDEPENDENT pad widths (the train step samples them
    independently): DeepSDF sample sets are typically heavily unbalanced,
    and one shared width would cyclically tile the smaller array up to
    ~2x the needed resident bytes in host RAM and HBM.
    """
    if not scene_samples:
        raise ValueError("no scenes")
    wp = max(len(p) for p, _ in scene_samples)
    wn = max(len(n) for _, n in scene_samples)
    pos = np.stack([_pad_cyclic(p, wp) for p, _ in scene_samples])
    neg = np.stack([_pad_cyclic(n, wn) for _, n in scene_samples])
    return ScenePack(
        pos=pos.astype(np.float32),
        neg=neg.astype(np.float32),
        pos_count=np.asarray([len(p) for p, _ in scene_samples], np.int32),
        neg_count=np.asarray([len(n) for _, n in scene_samples], np.int32),
        scales=(np.asarray(scales, np.float32) if scales is not None
                else np.full(len(scene_samples), np.nan, np.float32)),
        names=tuple(names if names is not None
                    else [str(i) for i in range(len(scene_samples))]),
    )


def load_scene_pack(data_source: str, split: dict,
                    scales: dict[str, float] | None = None) -> ScenePack:
    """Load every instance of a split into a ScenePack.

    scales: optional {instance_name: metric_scale} supervision for the
    scale head (sdflabel's decoder variant,
    deep_sdf_decoder_scale.py:68-75, predicts scale from the latent).
    """
    paths = split_instance_paths(data_source, split)
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    samples = [read_sdf_samples(p) for p in paths]
    sc = None
    if scales is not None:
        sc = [float(scales.get(n, np.nan)) for n in names]
    return pack_scenes(samples, names=names, scales=sc)


def sample_analytic_sdf(
    sdf_fn, rng: np.random.RandomState, n: int, extent: float = 1.1,
    surface_frac: float = 0.7, surface_sigma: float = 0.02,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate (pos, neg) sample rows from an analytic SDF — the external
    preprocessor's near-surface + uniform mix, for tests and synthetic
    experiments. `sdf_fn` maps (N, 3) -> (N,) true signed distances."""
    n_unif = int(n * (1.0 - surface_frac))
    pts_unif = rng.uniform(-extent, extent, (n_unif, 3))
    # near-surface: perturb uniform points toward the level set twice
    # (cheap projection via the true sdf and finite-difference normal)
    base = rng.uniform(-extent, extent, (n - n_unif, 3))
    for _ in range(2):
        d = np.asarray(sdf_fn(base)).reshape(-1, 1)
        eps = 1e-3
        grad = np.stack([
            (np.asarray(sdf_fn(base + eps * np.eye(3)[k])) -
             np.asarray(sdf_fn(base - eps * np.eye(3)[k]))) / (2 * eps)
            for k in range(3)
        ], axis=1)
        grad /= np.maximum(np.linalg.norm(grad, axis=1, keepdims=True), 1e-9)
        base = base - d * grad
    near = base + rng.randn(len(base), 3) * surface_sigma
    pts = np.concatenate([pts_unif, near]).astype(np.float32)
    sdf = np.asarray(sdf_fn(pts), np.float32).reshape(-1, 1)
    rows = np.concatenate([pts, sdf], axis=1)
    pos = rows[rows[:, 3] >= 0]
    neg = rows[rows[:, 3] < 0]
    if len(pos) == 0 or len(neg) == 0:
        raise ValueError("analytic SDF produced a one-sided sample set")
    return pos, neg
