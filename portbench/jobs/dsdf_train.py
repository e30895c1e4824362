"""Job "dsdf_train": train the DeepSDF decoder and its code table, one step
after another, through ``engine/deepsdf_train.py::train_step``.

The generator reads a traffic file (portbench/traffic/*.json with "job":
"dsdf_train") and makes the scene pack on the card from the seed: per
scene a car-proportioned rounded box (half-extents and rounding drawn from
the file's ranges), its positive rows on and outside the surface, its
negative rows inside, as DeepSDF's preprocessing samples them: points of
the surface moved along the normal by N(0, sigma^2) at the file's two
sigmas, and uniform points outside. Every row's sdf is exact. Nothing is
written to disk. Each step draws its scenes from a shuffled epoch.

Set-up builds the training state (weights and codes made from the seed),
runs the first `check_steps` steps through train_step itself (they warm it
up) and keeps what the check compares; the same state then steps through
the window. The check runs the reference's steps from the same start with
a generator seeded as the program's.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from portbench import common, counts
from portbench import weights as weights_mod
from portbench.reference import dsdf_ref as ref

# limits of the compared numbers, set on the card from the program's
# readings over a dozen seeds and more and the control's (the reference
# with TF32 on); PERF.md gives both
LIMITS = {"loss_gap": 3e-4, "grad_gap": 1e-5, "change_gap": 1e-4}
# leaves whose first reference gradient is under this share of the median
# leaf's move by round-off alone under Adam; the change leaves them out
NOUGHT_GRAD = 1e-3


def make_pack(traffic: dict, seed: int, device):
    """(pos, neg, pos_count, neg_count) on the card: (S, P, 4) rows."""
    S = traffic["scenes"]
    half = traffic["rows_per_scene"] // 2
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63 - 1))
    lo = torch.tensor(traffic["half_extent_lo"], device=device)
    hi = torch.tensor(traffic["half_extent_hi"], device=device)
    h = lo + (hi - lo) * torch.rand(S, 3, generator=gen, device=device)
    r = traffic["rounding"][0] + (traffic["rounding"][1] - traffic[
        "rounding"][0]) * torch.rand(S, generator=gen, device=device)
    sig = torch.tensor(traffic["surface_sigmas"], device=device)
    pos = torch.empty(S, half, 4, device=device)
    neg = torch.empty(S, half, 4, device=device)
    n_unif = int(half * traffic["uniform_share"])
    chunk = traffic.get("pack_chunk_scenes", 32)
    for a in range(0, S, chunk):
        hs, rs = h[a:a + chunk], r[a:a + chunk]
        c = hs.shape[0]
        for sign, out, n_near in ((1.0, pos, half - n_unif),
                                  (-1.0, neg, half)):
            pts, sdf = _near_surface(hs, rs, n_near, sig, sign, gen)
            out[a:a + c, :n_near, :3] = pts
            out[a:a + c, :n_near, 3] = sdf
        if n_unif:
            pts, sdf = _outside(hs, rs, n_unif, gen)
            pos[a:a + c, half - n_unif:, :3] = pts
            pos[a:a + c, half - n_unif:, 3] = sdf
    count = torch.full((S,), half, dtype=torch.long, device=device)
    return pos, neg, count, count.clone()


def _box_sdf(p, h, r):
    q = p.abs() - h[:, None, :]
    return (torch.linalg.norm(q.clamp(min=0), dim=-1)
            + q.amax(-1).clamp(max=0) - r[:, None])


def _near_surface(h, r, n, sig, sign, gen):
    """n points a scene off the flat faces of the rounded box, along the
    face normal by sign * |N(0, sigma^2)| (half at each sigma), kept
    within the rounding inside; their sdf is exactly that offset."""
    c, dev = h.shape[0], h.device
    area = torch.stack([h[:, 1] * h[:, 2], h[:, 0] * h[:, 2],
                        h[:, 0] * h[:, 1]], -1)
    axis = torch.multinomial(area, n, replacement=True, generator=gen)
    side = torch.where(torch.rand(c, n, generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    u = (torch.rand(c, n, 3, generator=gen, device=dev) * 2 - 1) * h[:, None]
    onehot = torch.nn.functional.one_hot(axis, 3).float()
    face = u * (1 - onehot) + onehot * (side[..., None] * h[:, None])
    s = sig[torch.arange(n, device=dev) % sig.shape[0]]
    eps = (torch.randn(c, n, generator=gen, device=dev) * s).abs() * sign
    eps = torch.maximum(eps, -0.9 * r[:, None])
    normal = onehot * side[..., None]
    pts = face + (r[:, None, None] + eps[..., None]) * normal
    return pts, eps


def _outside(h, r, n, gen):
    """n uniform points a scene in [-1, 1]^3 outside the rounded box (inside
    ones are pushed out along their largest axis), with their sdf."""
    c, dev = h.shape[0], h.device
    p = torch.rand(c, n, 3, generator=gen, device=dev) * 2 - 1
    d = _box_sdf(p, h, r)
    inside = d < 0
    k = p.abs().argmax(-1)
    onehot = torch.nn.functional.one_hot(k, 3).float()
    edge = (h[:, None, :] + r[:, None, None] + 0.05) * p.sign()
    p = torch.where(inside[..., None], p * (1 - onehot) + onehot * edge, p)
    return p, _box_sdf(p, h, r)


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.steps_run = 0

    def setup(self):
        clock = common.Stopwatch(self.sync)
        from sdflabel_tpu_torch.engine import deepsdf_train as dt
        from sdflabel_tpu_torch.models import deepsdf

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dt = dt
        dev, cfg, spec = self.device, self.config, self.config["NetworkSpecs"]
        self.pack = make_pack(self.traffic, self.seed, dev)
        clock.lap("pack")
        self.dcfg = deepsdf.DeepSDFConfig(
            latent_size=cfg["CodeLength"], dims=tuple(spec["dims"]),
            dropout=tuple(spec["dropout"]),
            dropout_prob=spec["dropout_prob"],
            norm_layers=tuple(spec["norm_layers"]),
            latent_in=tuple(spec["latent_in"]),
            weight_norm=spec["weight_norm"], xyz_in_all=spec["xyz_in_all"],
            use_tanh=spec["use_tanh"],
            latent_dropout=spec["latent_dropout"])
        self.tcfg = dt.DeepSDFTrainConfig.from_specs(cfg)
        S = self.traffic["scenes"]
        self.bsz, self.spe = dt.epoch_steps(S, self.tcfg.scenes_per_batch)
        wseed = (self.seed + 1) % (2 ** 63 - 1)
        self.params0 = weights_mod.torch_default(cfg, wseed, dev)
        g = torch.Generator(device=dev).manual_seed(wseed)
        lat = cfg["CodeLength"]
        self.codes0 = torch.randn(S, lat, generator=g, device=dev) * (
            cfg["CodeInitStdDev"] / math.sqrt(lat))
        pos, neg, pc, nc = self.pack
        self.tensors = dt.TrainTensors(types.SimpleNamespace(
            pos=pos, neg=neg, pos_count=pc, neg_count=nc,
            scales=torch.full((S,), math.nan, device=dev)), dev)
        state = dt.DeepSDFTrainState(
            {k: (dict(v) if isinstance(v, dict) else list(v))
             for k, v in self.params0.items()},
            self.codes0.clone(), dt.init_opt(self.params0, self.codes0), 0)
        self.order_rng = np.random.default_rng([self.seed % 2 ** 63, 3])
        self.epoch_order = []
        self.gen_seed = (self.seed + 2) % (2 ** 63 - 1)
        self.gen = torch.Generator(device=dev).manual_seed(self.gen_seed)
        clock.lap("state")
        # the first steps, through the window's own call and feed
        k = self.traffic["check_steps"]
        self.first_batches, self.first_losses = [], []
        for i in range(k):
            idx = self.next_batch()
            self.first_batches.append(idx)
            state, m = self.dt.train_step(self.dcfg, self.tcfg, self.spe,
                                          state, self.tensors, idx, self.gen)
            self.first_losses.append(m["loss"])
            if i == 0:
                self.first_grads = [
                    x / 0.1 for x in ref.leaves(state.opt["dec"].mu)
                ] + [ref.leaves(state.opt["codes"].mu)[0] / 0.1]
        clock.lap("first steps")
        self.setup_times = clock.laps
        self.first_losses = [float(x) for x in self.first_losses]
        self.after = ref.leaves(state.params) + [state.codes]
        self.after = [x.detach().clone() for x in self.after]
        self.state = state
        self.sync()
        self.steps_run = 0

    def next_batch(self) -> torch.Tensor:
        """The next step's scenes: whole batches of shuffled epochs."""
        if not self.epoch_order:
            perm = self.order_rng.permutation(self.traffic["scenes"])
            self.epoch_order = [perm[i:i + self.bsz] for i in
                                range(0, self.bsz * self.spe, self.bsz)]
        return torch.as_tensor(self.epoch_order.pop(0), device=self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        self.state, _ = self.dt.train_step(self.dcfg, self.tcfg, self.spe,
                                           self.state, self.tensors,
                                           self.next_batch(), self.gen)
        self.steps_run += 1

    def rows_per_step(self) -> int:
        return self.bsz * self.config["SamplesPerScene"]

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"sdf_rows_per_s": units * self.rows_per_step() / window_s}

    def attempted_failed(self) -> tuple[int, int]:
        return self.steps_run, 0

    def limits(self) -> dict:
        return dict(LIMITS)

    def close(self):
        """Nothing of this job outlives the run."""

    def release(self):
        self.state = None
        self.tensors = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample_all: bool = False, control: str | None = None
              ) -> dict:
        """loss_gap (the first steps' losses), grad_gap (the first gradient
        as the optimizer got it, by the worst leaf's norm) and change_gap
        (the parameters' change over the first steps, by the worst leaf's
        norm), the program's against the reference's. `control`: "tf32"
        puts the reference with TF32 on in the program's place,
        "half_batch" the reference stepping on half of each batch."""
        ref_out = self._reference()
        if control is None:
            prog = (self.first_losses, self.first_grads, self.after)
        elif control == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                prog = self._reference()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        elif control == "half_batch":
            prog = self._reference(half_batch=True)
        else:
            raise ValueError(f"unknown control {control!r}")
        return self.compare(prog, ref_out)

    def _reference(self, half_batch: bool = False):
        gen = torch.Generator(device=self.device).manual_seed(self.gen_seed)
        losses, first, params, codes = ref.train_steps(
            self.config, self.params0, self.codes0, self.pack,
            self.first_batches, gen, self.spe, half_batch=half_batch)
        return losses, first, ref.leaves(params) + [codes]

    def compare(self, prog, want) -> dict:
        lp, gp, ap = prog
        lr_, gr, ar = want
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(lp, lr_))
        grad_gap, g_at = ref.norm_gaps(gp, gr)
        norms = [float(torch.linalg.norm(g)) for g in gr]
        med = sorted(norms)[len(norms) // 2]
        skip = {i for i, n in enumerate(norms) if n < NOUGHT_GRAD * med}
        start = ref.leaves(self.params0) + [self.codes0]
        change_gap, c_at = ref.norm_gaps([a - s for a, s in zip(ap, start)],
                                         [b - s for b, s in zip(ar, start)],
                                         skip)
        names = ref.leaf_names(self.params0) + ["codes"]
        self.skipped_leaves = [names[i] for i in sorted(skip)]
        self.worst_leaves = {"grad_gap": names[g_at],
                             "change_gap": names[c_at]}
        return {"loss_gap": loss_gap, "grad_gap": grad_gap,
                "change_gap": change_gap}

    def layer_context(self) -> dict:
        lat = self.config["CodeLength"]
        spec = self.config["NetworkSpecs"]
        macs = counts.decoder_macs(lat, spec["dims"], spec["latent_in"])
        return {"train_flops": 3 * 2.0 * macs * self.rows_per_step()
                * self.steps_run,
                "train_peak": counts.FP32_FLOPS}
