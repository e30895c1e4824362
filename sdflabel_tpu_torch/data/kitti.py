"""KITTI-3D frames: calib, labels, LIDAR, preprocessing, annotation filters.

Counterpart of sdflabel_tpu/data/kitti.py (reference datasets/kitti.py,
utils/refinement.py:15-57, 565-583). The card's machine has neither cv2
nor Open3D, so:
  * ``image_2`` PNGs are read by utils/png.py and flipped to the BGR
    channel order that ``cv2.imread(path, -1)`` gives, which the whole
    crop chain expects;
  * the projection matrix is split into intrinsics and rotation by
    ``decompose_projection``, OpenCV's Givens RQ decomposition written out
    in numpy, and the camera centre is the matrix's null vector;
  * normals are k-NN PCA on scipy's cKDTree, as in the JAX package.
Everything here is host numpy.
"""

from __future__ import annotations

import os
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from sdflabel_tpu_torch.ops import geometry
from sdflabel_tpu_torch.utils import png


def is_anno_easy(anno) -> bool:
    """refinement.py:15-27."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 0 or anno["truncated"] > 0.15
                or height < 40)


def is_anno_moderate(anno) -> bool:
    """refinement.py:30-41."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 1 or anno["truncated"] > 0.30
                or height < 25)


def is_anno_hard(anno) -> bool:
    """refinement.py:44-57."""
    height = anno["bbox"][3] - anno["bbox"][1]
    return not (anno["occluded"] > 2 or anno["truncated"] > 0.5
                or height < 25)


def get_annos(diff_annos: str, sample: dict) -> list[dict]:
    """Annotations up to a difficulty, sorted by depth
    (refinement.py:565-583)."""
    if diff_annos == "hard":
        annos = (sample["annos"]["easy"] + sample["annos"]["medium"]
                 + sample["annos"]["hard"])
    elif diff_annos == "medium":
        annos = sample["annos"]["easy"] + sample["annos"]["medium"]
    else:
        annos = sample["annos"]["easy"]
    return sorted(annos, key=lambda a: a["location"][2])


def read_bgr(path: str) -> np.ndarray:
    """(H, W, 3) uint8 in BGR order, as cv2.imread(path, -1) gives an
    8-bit colour PNG."""
    return np.ascontiguousarray(png.read(path)[..., ::-1])


def write_bgr(path: str, img: np.ndarray) -> None:
    """Store a BGR uint8 image as cv2.imwrite does: RGB in the file."""
    png.write(path, np.ascontiguousarray(np.asarray(img)[..., ::-1]))


def _rq_decomp3x3(m: np.ndarray):
    """OpenCV's RQDecomp3x3: m = r @ q with r upper triangular and q a
    rotation, by three Givens rotations; where r[0, 0] or r[1, 1] comes out
    negative, a 180-degree turn makes them positive."""
    eps = np.finfo(np.float64).eps

    def givens(c, s):
        z = 1.0 / np.sqrt(c * c + s * s + eps)
        return c * z, s * z

    c, s = givens(m[2, 2], m[2, 1])
    qx = np.array([[1.0, 0, 0], [0, c, s], [0, -s, c]])
    r = m @ qx
    r[2, 1] = 0.0
    c, s = givens(r[2, 2], -r[2, 0])
    qy = np.array([[c, 0, -s], [0, 1.0, 0], [s, 0, c]])
    mm = r @ qy
    mm[2, 0] = 0.0
    c, s = givens(mm[1, 1], mm[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]])
    r = mm @ qz
    r[1, 0] = 0.0
    if r[0, 0] < 0:
        if r[1, 1] < 0:  # 180 degrees about z
            r[:, 0] *= -1
            r[:, 1] *= -1
            qz[:2, :2] *= -1
            return r, qz.T @ qy.T @ qx.T
        flip = np.diag([-1.0, 1.0, -1.0])  # 180 degrees about y
    elif r[1, 1] < 0:
        flip = np.diag([1.0, -1.0, -1.0])  # 180 degrees about x
    else:
        return r, qz.T @ qy.T @ qx.T
    return r @ flip, flip @ qz.T @ qy.T @ qx.T


def decompose_projection(p: np.ndarray):
    """cv2.decomposeProjectionMatrix(p)[:3]: (intrinsics (3, 3), rotation
    (3, 3), homogeneous camera centre (4, 1))."""
    p = np.asarray(p, np.float64).reshape(3, 4)
    _, _, vt = np.linalg.svd(np.vstack([p, np.zeros((1, 4))]))
    k, rot = _rq_decomp3x3(p[:, :3].copy())
    return k, rot, vt[3][:, None]


def estimate_normals(points: np.ndarray, radius: float = 1.0,
                     max_nn: int = 30) -> np.ndarray:
    """k-NN PCA normals (kitti.py:22's Open3D estimate_normals): the
    smallest-eigenvalue eigenvector of each point's covariance over up to
    max_nn neighbours within radius, turned towards the sensor."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    dists, idxs = tree.query(points, k=max_nn, distance_upper_bound=radius)
    valid = np.isfinite(dists)
    idxs = np.where(valid, idxs, 0)
    neigh = points[idxs]  # (N, K, 3)
    w = valid.astype(np.float64)[..., None]
    cnt = np.maximum(w.sum(axis=1), 1.0)
    mean = (neigh * w).sum(axis=1) / cnt
    centered = (neigh - mean[:, None, :]) * w
    cov = np.einsum("nki,nkj->nij", centered, centered) / cnt[..., None]
    _, eigvecs = np.linalg.eigh(cov)
    normals = eigvecs[:, :, 0]
    flip = np.sign(-np.einsum("ni,ni->n", normals, points))
    flip = np.where(flip == 0, 1.0, flip)
    return normals * flip[:, None]


def get_kitti_frame(sample: dict):
    """Frame preprocessing (kitti.py:12-47): frustum cull, normals, road
    removal by the normal's y component, depth map, coloured points."""
    h, w, _ = sample["image"].shape
    scene_lidar = sample["lidar"]
    frustum = geometry.build_view_frustum(sample["orig_cam"], 0, 0, w, h)
    scene_lidar = scene_lidar[
        np.logical_and.reduce(frustum @ scene_lidar.T > 0, axis=0)]
    if len(scene_lidar) > 0:
        normals = estimate_normals(scene_lidar)
        ortho_to_cam = np.abs(normals @ np.asarray([0.0, 1.0, 0.0])) > 0.9
        scene_lidar = scene_lidar[~ortho_to_cam]
    scene_depth = geometry.compute_depth_map(scene_lidar, sample["orig_cam"],
                                             w, h)
    pts_scene, clrs_scene = geometry.reproject_np(
        sample["image"], scene_depth, sample["orig_cam"])
    return scene_depth, (pts_scene, clrs_scene)


class KITTI3D:
    """KITTI-3D frames (datasets/kitti.py:50-205)."""

    def __init__(self, path, training=True, data_split="trainval",
                 compute_frame=True):
        assert data_split in ["test", "train", "trainval", "val"]
        self.path = path
        self.train = training
        self.data_split = data_split
        self.compute_frame = compute_frame
        with open(os.path.join(path, "mv3d_kitti_split",
                               data_split + ".txt")) as f:
            self.names = [line.strip() for line in f]
        self.root = os.path.join(
            path, "testing" if data_split == "test" else "training")
        self.images = [f"image_2/{n}.png" for n in self.names]
        self.label_files = [f"label_2/{n}.txt" for n in self.names]
        self.calibs = [f"calib/{n}.txt" for n in self.names]
        self.lidars = [f"velodyne/{n}.bin" for n in self.names]

    def __len__(self):
        return len(self.names)

    def __getitem__(self, index: int) -> dict:
        sample = OrderedDict()
        sample["idx"] = index
        sample["scale"] = 1
        sample["name"] = self.names[index]

        with open(os.path.join(self.root, self.calibs[index])) as f:
            calib = [c.rstrip("\n").split(" ") for c in f.readlines()]
        p2 = np.asarray([float(v) for v in calib[2][1:]]).reshape(3, 4)
        velo_to_cam = np.asarray([float(v) for v in calib[5][1:]]).reshape(
            3, 4)

        velodyne = np.fromfile(os.path.join(self.root, self.lidars[index]),
                               np.float32).reshape(-1, 4)[:, :3]
        sample["lidar"] = (velo_to_cam[:3, :3] @ velodyne.T).T \
            + velo_to_cam[:3, 3]

        img = read_bgr(os.path.join(self.root, self.images[index]))
        sample["image"] = img.astype(np.float32) / 255.0
        sample["orig_hw"] = img.shape[:2]

        cam, rot, t = decompose_projection(p2)
        sample["orig_cam"] = cam.copy()
        sample["world_to_cam"] = np.eye(4)
        sample["world_to_cam"][:3, :3] = rot
        sample["world_to_cam"][:3, 3] = (-t[:3, 0] / t[3, 0] if t[3, 0] != 0
                                         else -t[:3, 0])

        if self.data_split != "test" and self.train:
            sample["gt"] = self._parse_labels(
                os.path.join(self.root, self.label_files[index]))
            self._apply_ignore_heuristics(sample["gt"])

        annos = {"easy": [], "medium": [], "hard": []}
        for anno in sample.get("gt", []):
            if anno["name"] != "Car" or anno["ignore"]:
                continue
            if is_anno_easy(anno):
                annos["easy"].append(anno)
            elif is_anno_moderate(anno):
                annos["medium"].append(anno)
            else:
                annos["hard"].append(anno)
        sample["annos"] = annos

        if self.compute_frame:
            depth, pcd = get_kitti_frame(sample)
            sample["depth"] = depth
            sample["pcd"] = pcd
        return sample

    @staticmethod
    def _parse_labels(path: str) -> list[dict]:
        """KITTI label txt -> anno dicts (kitti.py:134-166)."""
        annos = []
        with open(path) as f:
            lines = f.readlines()
        for line in lines:
            label = line.rstrip("\n").split(" ")
            anno = {
                "name": label[0],
                "bbox": [int(float(b)) for b in label[4:8]],
                "location": [float(b) for b in label[11:14]],
                "dimensions": [float(b) for b in label[8:11]],
                "rotation_y": float(label[14]),
                "alpha": float(label[3]),
                "score": 1,
                "truncated": float(label[1]),
                "occluded": int(label[2]),
            }
            anno["ignore"] = anno["location"][0] < -100
            annos.append(anno)
        return annos

    @staticmethod
    def _apply_ignore_heuristics(gt: list[dict]) -> None:
        """Occlusion-subsumption heuristics (kitti.py:168-186)."""
        for i, anno_i in enumerate(gt):
            for j, anno_j in enumerate(gt):
                if anno_i["name"] != "Car" or j == i:
                    continue
                inter_lt = np.maximum(anno_i["bbox"][:2], anno_j["bbox"][:2])
                inter_br = np.minimum(anno_i["bbox"][2:], anno_j["bbox"][2:])
                inter_wh = np.maximum(
                    np.asarray(inter_br) - np.asarray(inter_lt), 0)
                area = (anno_i["bbox"][2] - anno_i["bbox"][0]) * (
                    anno_i["bbox"][3] - anno_i["bbox"][1])
                intersection = inter_wh[0] * inter_wh[1] / max(area, 1)
                if intersection > 0.5 and anno_j["name"] == "DontCare":
                    anno_i["ignore"] = True
                if not anno_i["ignore"] and not anno_j["ignore"]:
                    if (anno_i["location"][2] > anno_j["location"][2]
                            and intersection > 0.95):
                        anno_i["ignore"] = True
                        break


def prefetch_frames(dataset, indices, skip_fn=None, depth: int = 2):
    """Iterate (frame_idx, sample) while a worker thread loads the next
    frames (kitti.py:240-280). skip_fn(idx) -> True yields (idx, None)
    without loading the frame."""
    indices = list(indices)
    with ThreadPoolExecutor(max_workers=1) as pool:
        q: deque = deque()
        pos = 0

        def fill():
            nonlocal pos
            while pos < len(indices) and len(q) < max(depth, 1):
                i = indices[pos]
                pos += 1
                if skip_fn is not None and skip_fn(i):
                    q.append((i, None))
                else:
                    q.append((i, pool.submit(dataset.__getitem__, i)))

        fill()
        while q:
            i, fut = q.popleft()
            fill()  # keep the next load in flight while this one is used
            yield i, (None if fut is None else fut.result())
