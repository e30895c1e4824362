"""DeepSDF decoder training over an experiment directory.

Counterpart of sdflabel_tpu/pipelines/train_deepsdf.py. It follows the
external trainer's experiment conventions -- ``specs.json`` (NetworkSpecs
and the schedule keys), a ``TrainSplit`` json resolving to ``SdfSamples``
npz scenes -- and writes:

  * ``ModelParameters/<checkpoint>.pth``  {'epoch', 'model_state_dict'}
  * ``LatentCodes/<checkpoint>.pth``      {'epoch', 'latent_codes',
    'instance_names'}
  * ``<experiment>/deepsdf.pt`` + ``deepsdf.json``, the single-file pair
    that the refine pipelines load (the port's ``load_torch_checkpoint``
    and the JAX package's ``setup_dsdf`` alike).

Run: ``python -m sdflabel_tpu_torch.pipelines.train_deepsdf EXPERIMENT_DIR
[--data SOURCE] [--epochs N] [--seed S] [--no-resume] [--device cpu]``.
It trains on the card unless ``--device cpu`` is given, in fp32 with TF32
off. The full state (decoder, code table, both Adam groups, step) is
saved under ``Checkpoints/`` in the port's own format (utils/checkpoint.py;
JAX uses orbax) and a rerun resumes from it.

Data-parallel: ``train_deepsdf(mesh=)`` on each rank of a parallel/mesh.py
layout steps on its share of every batch's scenes
(deepsdf_train.shard_train_step), and rank 0 alone writes. ``--devices N``
(N > 1) spawns the N ranks itself, one card each (NCCL), or N processes
on the CPU with ``--device cpu`` (gloo).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Any

import numpy as np
import torch

from sdflabel_tpu_torch.data import sdf_samples
from sdflabel_tpu_torch.engine import deepsdf_train
from sdflabel_tpu_torch.engine.refine import _device
from sdflabel_tpu_torch.models import deepsdf, deepsdf_workspace as ws
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.utils import checkpoint as ckpt_mod


def save_reference_checkpoints(experiment_dir: str, cfg, state, names,
                               checkpoint: str = "latest",
                               epoch: int = 0) -> None:
    """ModelParameters/ and LatentCodes/ in the reference layout, and the
    single-file pair at the experiment root."""
    state_dict = deepsdf.torch_state_from_params(cfg, state.params)
    torch.save({"epoch": epoch, "model_state_dict": state_dict},
               os.path.join(ws.get_model_params_dir(experiment_dir, True),
                            checkpoint + ".pth"))
    torch.save({"epoch": epoch,
                "latent_codes": state.codes.detach().to("cpu").clone(),
                "instance_names": list(names)},
               os.path.join(ws.get_latent_codes_dir(experiment_dir, True),
                            checkpoint + ".pth"))
    deepsdf.save_torch_checkpoint(os.path.join(experiment_dir, "deepsdf.pt"),
                                  cfg, state.params, epoch=epoch)


def _ckpt_dir(experiment_dir: str) -> str:
    return os.path.join(experiment_dir, "Checkpoints")


def save_resume_state(experiment_dir: str, state) -> str:
    return ckpt_mod.save_tree(_ckpt_dir(experiment_dir),
                              deepsdf_train.state_tree(state), state.step)


def restore_resume_state(path: str, device) -> deepsdf_train.DeepSDFTrainState:
    return deepsdf_train.state_from_tree(ckpt_mod.load_tree(path, device))


def latest_resume_state(experiment_dir: str) -> str | None:
    return ckpt_mod.latest_checkpoint(_ckpt_dir(experiment_dir))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of global step `step`: its rows and dropout masks
    depend only on (seed, step), so a resumed run draws what an unbroken
    one draws."""
    return torch.Generator(device=device).manual_seed(
        (seed + 1) * 1_000_003 + step)


def train_deepsdf(experiment_dir: str, data_source: str | None = None,
                  num_epochs: int | None = None, mesh=None, seed: int = 0,
                  log_every: int = 10, resume: bool = True,
                  scales: dict[str, float] | None = None, device="cuda",
                  step_wrapper=None) -> deepsdf_train.DeepSDFTrainState:
    """Train a decoder and its codes per the experiment's specs.json;
    returns the final state. `step_wrapper(step_fn) -> step_fn` may wrap
    the step (a timer, an operator watch); the step's metrics stay on the
    device unless a log epoch reads them. `mesh`: this rank's
    parallel/mesh.py layout, to train data-parallel over its data axis
    (every rank calls this with the same arguments)."""
    device = _device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    specs = ws.load_experiment_specifications(experiment_dir)
    cfg = deepsdf.DeepSDFConfig.from_specs(specs)
    tcfg = deepsdf_train.DeepSDFTrainConfig.from_specs(specs)
    data_source = data_source or specs.get("DataSource", experiment_dir)
    split_path = specs["TrainSplit"]
    if not os.path.isabs(split_path):
        split_path = os.path.join(experiment_dir, split_path)
    pack = sdf_samples.load_scene_pack(
        data_source, sdf_samples.load_split_file(split_path), scales=scales)
    num_epochs = int(num_epochs or specs.get("NumEpochs", 100))
    snapshot_every = int(specs.get("SnapshotFrequency", max(1, num_epochs)))
    n = pack.num_scenes
    bsz, spe = deepsdf_train.epoch_steps(n, tcfg.scenes_per_batch)
    step = deepsdf_train.train_step
    lead = True
    if mesh is not None:
        step = deepsdf_train.shard_train_step(step, mesh)
        lead = mesh.rank == 0
        if bsz % mesh.shape["data"] != 0:
            raise ValueError(
                f"scenes_per_batch {bsz} must divide over the mesh "
                f"({mesh.shape['data']} data shards)")

    state = deepsdf_train.init_train_state(
        cfg, tcfg, n, torch.Generator().manual_seed(seed), device)
    start_epoch = 0
    if resume:
        latest = latest_resume_state(experiment_dir)
        if latest is not None:
            state = restore_resume_state(latest, device)
            start_epoch = state.step // spe
            print(f"resumed from {latest} (epoch {start_epoch})")
    tensors = deepsdf_train.TrainTensors(pack, device)

    def step_fn(state, scene_idx):
        return step(cfg, tcfg, spe, state, tensors, scene_idx,
                    step_generator(seed, state.step, device))

    if step_wrapper is not None:
        step_fn = step_wrapper(step_fn)
    metrics: dict[str, Any] = {}
    for epoch in range(start_epoch, num_epochs):
        # the host's epoch shuffle of the scenes (the external DataLoader),
        # fixed by (seed, epoch) for an exact resume
        order = np.random.RandomState(seed * 100003 + epoch).permutation(n)
        t0 = time.time()
        for s in range(spe):
            scene_idx = torch.as_tensor(order[s * bsz:(s + 1) * bsz],
                                        device=device)
            state, metrics = step_fn(state, scene_idx)
        if lead and ((epoch + 1) % log_every == 0
                     or epoch == num_epochs - 1):
            m = {k: float(v) for k, v in metrics.items()}
            print(f"epoch {epoch + 1}/{num_epochs} loss={m['loss']:.6f} "
                  f"l1={m['loss_l1']:.6f} reg={m['loss_reg']:.2e} "
                  f"scale={m['loss_scale']:.2e} |z|={m['code_norm']:.3f} "
                  f"({time.time() - t0:.1f}s/epoch)")
        if lead and ((epoch + 1) % snapshot_every == 0
                     or epoch == num_epochs - 1):
            save_reference_checkpoints(experiment_dir, cfg, state,
                                       pack.names, "latest", epoch=epoch + 1)
            save_resume_state(experiment_dir, state)
    return state


def _rank_main(rank: int, args) -> None:
    """One rank of ``--devices N``: its card (or the CPU), the mesh of all
    ranks, and the training."""
    device = args.device
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    train_deepsdf(args.experiment_dir, data_source=args.data,
                  num_epochs=args.epochs, mesh=mesh_mod.make_mesh(),
                  seed=args.seed, resume=not args.no_resume, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("experiment_dir")
    ap.add_argument("--data", default=None, help="data source override")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel over N devices (0 = single)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.devices > 1:
        mesh_mod.spawn_ranks(_rank_main, args.devices, (args,),
                             backend=mesh_mod.default_backend(args.device))
        return
    train_deepsdf(args.experiment_dir, data_source=args.data,
                  num_epochs=args.epochs, seed=args.seed,
                  resume=not args.no_resume, device=args.device)


if __name__ == "__main__":
    main()
