"""Job "refine": label KITTI frames by refinement, one frame after another.

The generator reads a traffic file (portbench/traffic/*.json with "job":
"refine") and makes, in set-up, a pool of frames of `cars_per_frame` easy
cars each. Each car's crop is what the driver's ``prepare_crop`` hands the
refine: crop intrinsics under the 32^2 area budget, a NOCS target, the
frustum's LIDAR points and a start pose. The geometry (distance, yaw,
nominal size, hence every box and crop size) comes from the file's
``design_seed``, so every run seed has the same set of frame sizes; the run
seed draws the decoder's weights, each car's latent and true scale, its
LIDAR points, its start and the frames' order. The NOCS target and the car's
LIDAR are rendered by the plain reference from the true pose.

The window drives ``pipelines/refine_css.py::refine_crops_batched`` on each
frame's crops and reads the labels back, over whole passes of the pool. Afterwards the reference follows
a sample of the window's frames iteration by iteration from the program's
own history (reference/refine_ref.py says why) and re-derives each
sampled label from the program's final parameters.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench import common, counts
from portbench import weights as weights_mod
from portbench.reference import refine_ref as ref

# each number the check compares: its limit, set on the card from the
# program's readings over a dozen seeds and more and the control's (fp8
# decoder) readings; PERF.md gives both
LIMITS = {"start_gap": 0.0, "loss_gap": 0.03, "step_gap": 0.2,
          "label_gap": 0.01}


# -------------------------------------------------------------- generator

def camera_K(cam: dict) -> np.ndarray:
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                     [0.0, 0.0, 1.0]])


def _render_rot(yaw: float) -> np.ndarray:
    """The refine's render rotation: about +Y by yaw, Y row negated."""
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0, s], [0, -1.0, 0], [-s, 0, c]])


def design(traffic: dict) -> list[dict]:
    """The pool's geometry, from the file's design seed alone: per car its
    distance, yaw, lateral place, nominal size (KITTI's car statistics)
    and the 2D box of its nominal 3D box, at least `min_box_height_px` tall
    and inside the image."""
    rng = np.random.default_rng(traffic["design_seed"])
    cam = traffic["camera"]
    K = camera_K(cam)
    dims = traffic["car_dims_m"]
    n = traffic["frames"] * traffic["cars_per_frame"]
    out = []
    while len(out) < n:
        z = rng.uniform(*traffic["distance_m"])
        yaw = rng.uniform(-math.pi, math.pi)
        h, w, l = (float(np.clip(rng.normal(*dims[k]), dims[k][0]
                                 - 2 * dims[k][1], dims[k][0]
                                 + 2 * dims[k][1]))
                   for k in ("height", "width", "length"))
        x = rng.uniform(-0.7, 0.7) * z * cam["cx"] / cam["fx"]
        t = np.array([x, cam["height_m"] - h / 2, z])
        corners = np.array([[sx * w / 2, sy * h / 2, sz * l / 2]
                            for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)])
        pc = corners @ _render_rot(yaw).T + t
        if (pc[:, 2] < 1.0).any():
            continue
        uv = pc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        lt, rb = np.floor(uv.min(0)), np.ceil(uv.max(0))
        if (lt < 0).any() or rb[0] >= cam["width"] or rb[1] >= cam["height"]:
            continue
        if rb[1] - lt[1] < traffic["min_box_height_px"]:
            continue
        bbox = [int(lt[0]), int(lt[1]), int(rb[0]), int(rb[1])]
        bh, bw = bbox[3] - bbox[1], bbox[2] - bbox[0]
        ratio = math.sqrt(traffic.get("crop_area", 32 ** 2) / (bh * bw))
        Kc = K.astype(np.float32).copy()
        Kc[0, 2] -= bbox[0]
        Kc[1, 2] -= bbox[1]
        Kc[:2] *= ratio
        out.append({"z": z, "yaw": yaw, "x": x, "dims": (h, w, l),
                    "bbox": bbox, "crop_hw": (int(bh * ratio),
                                              int(bw * ratio)),
                    "K_crop": Kc})
    return out


def true_surfaces(decoder, grid, latents, rc: dict, chunk: int = 8):
    """Each latent's surface band (unit frame): (points (C, K, 3), unit
    normals, mask), decoded by the reference in chunks of latents."""
    pts, nrm, msk = [], [], []
    for i in range(0, latents.shape[0], chunk):
        lat = latents[i:i + chunk]
        cand = ref.select(decoder, lat, grid, rc["warm_band"])
        p, n, m = ref.stage2(decoder, lat, grid[cand],
                             rc["surface_threshold"])
        pts.append(p.detach())
        nrm.append(n)
        msk.append(m)
    return torch.cat(pts), torch.cat(nrm), torch.cat(msk)


def make_pool(traffic: dict, rc: dict, decoder, grid, seed: int, device):
    """(frames, order): frames as lists of crop dicts, each with the
    benchmark's inputs (the program's prepare_crop fields) and its truth."""
    slots = design(traffic)
    rng = np.random.default_rng([seed % 2 ** 63, 1])
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63 - 1))
    n = len(slots)
    lat = torch.randn(n, 3, generator=gen, device=device)
    lat = lat / torch.linalg.norm(lat, dim=1, keepdim=True)
    pts, nrm, msk = true_surfaces(decoder, grid, lat, rc)
    cam = traffic["camera"]
    K = camera_K(cam)
    npts = traffic["lidar_points"]
    crops = []
    for i, sl in enumerate(slots):
        p_valid = pts[i][msk[i]]
        length_u = float(p_valid[:, 2].max() - p_valid[:, 2].min())
        s = sl["dims"][2] / length_u
        ymin_u = float(p_valid[:, 1].min())
        T = np.array([sl["x"], cam["height_m"] + ymin_u * s, sl["z"]])
        h, w = sl["crop_hw"]
        Kc = torch.as_tensor(sl["K_crop"], device=device)
        pose = ref.render_pose(
            torch.tensor([[sl["yaw"]]], device=device, dtype=torch.float32),
            torch.as_tensor(T / s, device=device, dtype=torch.float32)[None])
        with torch.no_grad():
            color, pc, front, _ = ref.render_crop(Kc, (h, w), pts[i], nrm[i],
                                                  msk[i], pose[0])
        # LIDAR: the car's front points inside the box, ground, clutter
        car = (pc[front] * s).cpu().numpy().astype(np.float64)
        l, t, r, b = sl["bbox"]
        uv = car @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        car = car[(uv[:, 0] >= l) & (uv[:, 0] < r) & (uv[:, 1] >= t)
                  & (uv[:, 1] < b)]
        share = min(0.9, traffic["lidar_car_share_at_10m"]
                    * (10.0 / sl["z"]) ** 2)
        n_car = min(int(round(npts * share)), npts) if len(car) else 0
        car = car[rng.integers(0, max(len(car), 1), n_car)] \
            + rng.normal(0, traffic["lidar_noise_m"], (n_car, 3))
        n_ground = int(round((npts - n_car) * traffic["lidar_ground_share"]))
        v_lo = max(t, cam["cy"] + cam["fy"] * cam["height_m"] / 80.0)
        u = rng.uniform(l, r, n_ground)
        v = rng.uniform(v_lo, max(b, v_lo + 1), n_ground)
        ray = np.stack([(u - cam["cx"]) / cam["fx"],
                        (v - cam["cy"]) / cam["fy"], np.ones(n_ground)], 1)
        ground = ray * (cam["height_m"] / ray[:, 1:2])
        n_cl = npts - n_car - n_ground
        u = rng.uniform(l, r, n_cl)
        v = rng.uniform(t, b, n_cl)
        zc = np.maximum(2.0, sl["z"] + rng.uniform(*traffic[
            "clutter_depth_m"], n_cl))
        clutter = np.stack([(u - cam["cx"]) / cam["fx"] * zc,
                            (v - cam["cy"]) / cam["fy"] * zc, zc], 1)
        frustum = np.concatenate([car, ground, clutter]).astype(np.float32)
        # the start: the truth moved as the driver's RANSAC init is
        s0 = s * (1 + rng.uniform(-1, 1) * traffic["start_scale"])
        yaw0 = sl["yaw"] + rng.uniform(-1, 1) * traffic["start_yaw_rad"]
        T0 = T + rng.uniform(-1, 1, 3) * traffic["start_trans_m"]
        z0 = lat[i].cpu().numpy() + rng.normal(
            0, traffic["latent_start_noise"], 3)
        z0 = z0 / np.linalg.norm(z0)
        crops.append({
            "start": (np.float32(yaw0), (T0 / s0).astype(np.float32),
                      np.float32(s0), z0.astype(np.float32)),
            "intrinsics": sl["K_crop"], "crop_hw": (h, w),
            "nocs_target": color.cpu().numpy().astype(np.float32),
            "frustum": frustum, "fmask": np.ones(npts, bool),
            "anno": {"bbox": sl["bbox"]},
            "truth": {"yaw": sl["yaw"], "T": T, "scale": s}})
    per = traffic["cars_per_frame"]
    frames = [crops[i:i + per] for i in range(0, n, per)]
    order = [int(i) for i in rng.permutation(len(frames))]
    return frames, order


# -------------------------------------------------------------------- job

def decoder_spec(config: dict) -> tuple[int, list, list]:
    spec = config["NetworkSpecs"]
    return config["CodeLength"], spec["dims"], spec["latent_in"]


class Job:
    """One refine cell: set-up, one frame a unit, the check, the counts."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.rc = config["refine"]
        self.captured = []   # (final, history, extents) of each frame
        self.done = []       # (frame index, labels) of each frame
        self.footprint_pairs = []  # of the followed frames' renders
        self.frames_run = 0

    # set-up ------------------------------------------------------------
    def setup(self):
        clock = common.Stopwatch(self.sync)
        from sdflabel_tpu_torch import config as cfg_mod
        from sdflabel_tpu_torch.engine import refine as refine_mod
        from sdflabel_tpu_torch.models import deepsdf
        from sdflabel_tpu_torch.parallel import batched_refine
        from sdflabel_tpu_torch.pipelines import refine_css

        dev = self.device
        self.refine_css = refine_css
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = weights_mod.geometric(self.config, self.seed % (
            2 ** 63 - 1), dev)
        spec = self.config["NetworkSpecs"]
        self.grid = ref.grid_points(self.rc["grid_density"], dev)
        self.ref_decoder = ref.Decoder(self.params, spec["latent_in"], "bf16")
        clock.lap("weights")
        self.frames, self.order = make_pool(self.traffic, self.rc,
                                            self.ref_decoder, self.grid,
                                            self.seed, dev)
        clock.lap("pool")
        rc = self.rc
        cfg = cfg_mod.RefineCfg(
            grid_density=rc["grid_density"],
            rendering_area=rc["rendering_area"], iters=rc["iters"],
            coarse_cells=rc["coarse_cells"],
            pose_estimator=rc["pose_estimator"], precision=rc["precision"],
            select_bf16=rc["select_bf16"], select_pallas=rc["select_pallas"],
            stage2_pallas=rc["stage2_pallas"], warm_band=rc["warm_band"],
            warm_refresh=rc["warm_refresh"],
            warm_refresh_cells=rc["warm_refresh_cells"],
            render_bucket=rc["render_bucket"], viz_type=rc["viz_type"],
            weight_2d=rc["weight_2d"], weight_3d=rc["weight_3d"])
        dcfg = deepsdf.DeepSDFConfig(
            latent_size=self.config["CodeLength"], dims=tuple(spec["dims"]),
            dropout=tuple(spec["dropout"]),
            dropout_prob=spec["dropout_prob"],
            norm_layers=tuple(spec["norm_layers"]),
            latent_in=tuple(spec["latent_in"]),
            weight_norm=spec["weight_norm"], xyz_in_all=spec["xyz_in_all"],
            use_tanh=spec["use_tanh"],
            latent_dropout=spec["latent_dropout"])
        # the runtime wants a CSS net; the refine never runs it (PERF.md
        # lists this set-up for a program change)
        self.rt = refine_css.RefineRuntime(cfg, torch.nn.Module(), dcfg,
                                           self.params, device=dev)
        self.preps = [[{
            "params0": refine_mod.init_refine_params(
                c["start"][0], c["start"][1], c["start"][2], c["start"][3],
                device=dev),
            **{k: c[k] for k in ("intrinsics", "crop_hw", "nocs_target",
                                 "frustum", "fmask", "anno")}}
            for c in frame] for frame in self.frames]
        clock.lap("runtime")
        self.sample = {"world_to_cam": np.eye(4)}
        # keep what the batched refine returns: the check follows it
        make = batched_refine.make_batched_refine
        captured = self.captured

        def spy(*args, **kw):
            fn = make(*args, **kw)

            def run(*a):
                out = fn(*a)
                captured.append(out)
                return out
            return run

        batched_refine.make_batched_refine = spy
        # warm up every render bucket the pool's frames use, once each
        seen = set()
        for f in self.order:
            hw = ref.bucket_hw(self.frames[f], rc["render_bucket"])
            if hw not in seen:
                seen.add(hw)
                self.refine_css.refine_crops_batched(self.rt, self.sample,
                                                     self.preps[f])
        clock.lap("warm-up")
        self.setup_times = clock.laps
        self.sync()
        self.captured.clear()
        self.done.clear()
        self.frames_run = 0
        # a window ends on a whole pass over the pool: the frames differ
        # in their card work, and a part-pass would let the host's speed
        # choose the mix
        self.units_per_pass = len(self.order)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        f = self.order[self.frames_run % len(self.order)]
        labels = self.refine_css.refine_crops_batched(
            self.rt, self.sample, self.preps[f])
        self.done.append((f, labels))
        self.frames_run += 1

    # results -----------------------------------------------------------
    def end_to_end(self, units: int, window_s: float) -> dict:
        """Nothing by the host's clock: the cell's rate is read from the
        card's trace (metrics/crops_per_card_s.py)."""
        return {}

    def attempted_failed(self) -> tuple[int, int]:
        att = sum(len(self.frames[f]) for f, _ in self.done)
        got = sum(len(lb) for _, lb in self.done)
        return att, att - got

    def limits(self) -> dict:
        return dict(LIMITS)

    def close(self):
        """Nothing of this job outlives the run."""

    def release(self):
        """Free the program's runtime before the reference runs."""
        self.rt = None
        self.preps = None

    def check(self, sample_all: bool = False, control: str | None = None
              ) -> dict:
        """The compared readings: the loss gap and the step gap over a
        sample of the window's frames drawn from the seed (every frame with
        `sample_all`), the label gap over every frame. `control` "fp8":
        the reference with its decoder in float8, the precision below the
        configuration's, put in the program's place."""
        if len(self.captured) != len(self.done):
            # the spy set up in setup() keeps what each call of the batched
            # refine returns; it sees only calls made through the module's
            # make_batched_refine, as refine_crops_batched makes them now
            print(f"portbench: the batched refine's outputs were kept for "
                  f"{len(self.captured)} of {len(self.done)} frames (the "
                  f"check follows each frame's history, taken where "
                  f"refine_crops_batched calls parallel/batched_refine."
                  f"make_batched_refine); no frame is judged",
                  file=sys.stderr)
            return {k: math.nan for k in LIMITS}
        decoder = None
        if control == "fp8":
            decoder = ref.Decoder(self.params, self.config["NetworkSpecs"][
                "latent_in"], "fp8")
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        n = len(self.done)
        rng = np.random.default_rng([self.seed % 2 ** 63, 2])
        k = n if sample_all else min(n, self.traffic["check_frames"])
        picks = sorted(rng.choice(n, k, replace=False).tolist())
        dec = self.ref_decoder
        loss_gap, label_gap, start_gap = 0.0, 0.0, 0.0
        num = {leaf: 0.0 for leaf in ref.LEAVES}
        den = {leaf: 0.0 for leaf in ref.LEAVES}
        self.footprint_pairs = []
        for j in picks:
            f, _ = self.done[j]
            final, hist, _ = self.captured[j]
            crops = self.frames[f]
            b = len(crops)
            hp = [t[:b].detach().float() for t in hist.params]
            fin = [t[:b].detach().float() for t in final]
            with torch.enable_grad():
                lr_, rsteps, psteps, pairs = ref.follow(
                    dec, self.rc, self.grid, crops, hp, fin, self.device)
                lp = hist.loss[:b].detach().float()
                if decoder is not None:  # the control's own losses, steps
                    lp, psteps, _, _ = ref.follow(
                        decoder, self.rc, self.grid, crops, hp, fin,
                        self.device)
            self.footprint_pairs += pairs
            # the start the program's history begins at is the input's
            for i, c in enumerate(crops):
                for h, want in zip(hp, c["start"]):
                    start_gap = max(start_gap, float(np.abs(
                        h[i, 0].cpu().numpy() - np.asarray(want)).max()))
            gap = (lp - lr_).abs() / lr_.abs().clamp(min=1e-6)
            loss_gap = max(loss_gap, float(gap.max()))
            for leaf, rs, ps in zip(ref.LEAVES, rsteps, psteps):
                num[leaf] += float((ps - rs).detach().square().sum())
                den[leaf] += float(rs.detach().square().sum())
        # every frame's labels from the program's final parameters: the
        # program's own (or, for the control, the control decoder's)
        # beside the reference's
        for (f, labels), (final, _, _) in zip(self.done, self.captured):
            b = len(self.frames[f])
            fin = [t[:b].detach().float() for t in final]
            want = self._labels(dec, fin, b)
            got = labels if decoder is None else self._labels(decoder, fin,
                                                              b)
            if None in want or None in got or len(got) != len(want):
                label_gap = math.inf
                continue
            for a, w in zip(got, want):
                label_gap = max(label_gap, ref.label_gap(a, w))
        step_gap = max((math.sqrt(num[k] / den[k]) for k in ref.LEAVES
                        if den[k] > 0), default=math.inf)
        return {"start_gap": start_gap, "loss_gap": loss_gap,
                "step_gap": step_gap, "label_gap": label_gap}

    def _labels(self, decoder, fin, b: int) -> list:
        """Each crop's KITTI label from the final parameters `fin` through
        `decoder`'s surface extents (None where the band is empty)."""
        with torch.enable_grad():
            mn, mx, valid = ref.extents(decoder, self.grid, fin[3],
                                        self.rc["warm_band"],
                                        self.rc["surface_threshold"])
        return [ref.kitti_label(float(fin[0][i, 0]), float(fin[2][i, 0]),
                                fin[1][i].cpu().numpy(), mn[i].cpu().numpy(),
                                mx[i].cpu().numpy(),
                                self.sample["world_to_cam"])
                if bool(valid[i]) else None for i in range(b)]

    # per-layer context -------------------------------------------------
    def layer_context(self) -> dict:
        """What the metrics' readers need besides the trace, for the
        window's frames (in a traced run every one of them was
        followed)."""
        lat, dims, latent_in = decoder_spec(self.config)
        rc = self.rc
        crops = sum(len(self.frames[f]) for f, _ in self.done)
        grid_n = rc["grid_density"] ** 3
        band = rc["warm_band"]
        refreshes = -(-rc["iters"] // rc["warm_refresh"])
        sel_flops, sel_bytes = counts.select_mlp_work(
            grid_n, lat, dims, latent_in)
        full = 2.0 * counts.decoder_macs(lat, dims, latent_in)
        decoder_flops = crops * (
            (refreshes + 1) * sel_flops + rc["iters"] * 3 * band * full
            + 2 * band * full)
        frames = [self.frames[f] for f, _ in self.done]
        per_call_pts = [len(fr) * band for fr in frames]
        hw = [ref.bucket_hw(fr, rc["render_bucket"]) for fr in frames]
        splat_bytes = sum(rc["iters"] * counts.splat_fwd_work(
            0, n, len(fr) * h * w)[1]
            for n, fr, (h, w) in zip(per_call_pts, frames, hw))
        return {
            "crops": crops,
            "iterations": len(self.done) * rc["iters"],
            "select_flops": sum(refreshes * len(fr) * sel_flops
                                for fr in frames),
            "select_bytes": sum(refreshes * len(fr) * sel_bytes
                                for fr in frames),
            "splat_sfu": 2.0 * sum(self.footprint_pairs),
            "splat_bytes": splat_bytes,
            "splat_pairs_known": bool(self.footprint_pairs),
            "decoder_flops": decoder_flops,
            "decoder_peak": counts.BF16_FLOPS,
        }
