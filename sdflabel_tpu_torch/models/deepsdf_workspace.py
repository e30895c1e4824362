"""DeepSDF experiment-directory conventions and checkpoint loading.

Counterpart of sdflabel_tpu/models/deepsdf_workspace.py, after the
reference's sdfrenderer/deepsdf/workspace.py: the experiment layout
(:10-22), specs (:26-35), decoder (:38-72) and latent codes (:75-92), the
directory helpers (:95-165) and the single-file ``setup_dsdf`` convention
(:167-188). Decoders load as the port's parameters (models/deepsdf.py) on
the device asked for.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from sdflabel_tpu_torch.models import deepsdf

model_params_subdir = "ModelParameters"
optimizer_params_subdir = "OptimizerParameters"
latent_codes_subdir = "LatentCodes"
logs_filename = "Logs.pth"
reconstructions_subdir = "Reconstructions"
reconstruction_meshes_subdir = "Meshes"
reconstruction_codes_subdir = "Codes"
specifications_filename = "specs.json"
data_source_map_filename = ".datasources.json"
evaluation_subdir = "Evaluation"
sdf_samples_subdir = "SdfSamples"
surface_samples_subdir = "SurfaceSamples"
normalization_param_subdir = "NormalizationParameters"


def load_experiment_specifications(experiment_directory: str) -> dict:
    filename = os.path.join(experiment_directory, specifications_filename)
    if not os.path.isfile(filename):
        raise FileNotFoundError(
            f"experiment directory {experiment_directory!r} has no "
            f"{specifications_filename}")
    with open(filename) as f:
        return json.load(f)


def load_decoder(experiment_directory: str, checkpoint: str, device="cuda"):
    """The decoder of ``ModelParameters/<checkpoint>.pth`` under the
    experiment's specs (workspace.py:38-72) -> (cfg, params on `device`,
    epoch)."""
    specs = load_experiment_specifications(experiment_directory)
    cfg = deepsdf.DeepSDFConfig.from_specs(specs)
    filename = os.path.join(experiment_directory, model_params_subdir,
                            checkpoint + ".pth")
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    data = torch.load(filename, map_location="cpu", weights_only=False)
    params = deepsdf.params_from_torch_state(cfg, data["model_state_dict"],
                                             device=device)
    return cfg, params, data["epoch"]


def load_latent_vectors(experiment_directory: str,
                        checkpoint: str) -> np.ndarray:
    """The per-scene latent codes of ``LatentCodes/<checkpoint>.pth``
    (workspace.py:75-92) -> (num_scenes, L) numpy."""
    filename = os.path.join(experiment_directory, latent_codes_subdir,
                            checkpoint + ".pth")
    if not os.path.isfile(filename):
        raise FileNotFoundError(filename)
    data = torch.load(filename, map_location="cpu", weights_only=False)
    codes = data["latent_codes"]
    if hasattr(codes, "detach"):
        codes = codes.detach().cpu().numpy()
    return np.asarray(codes).reshape(len(codes), -1)


def _dir(path: str, create_if_nonexistent: bool) -> str:
    if create_if_nonexistent:
        os.makedirs(path, exist_ok=True)
    return path


def get_model_params_dir(experiment_dir, create_if_nonexistent=False):
    return _dir(os.path.join(experiment_dir, model_params_subdir),
                create_if_nonexistent)


def get_latent_codes_dir(experiment_dir, create_if_nonexistent=False):
    return _dir(os.path.join(experiment_dir, latent_codes_subdir),
                create_if_nonexistent)


def get_evaluation_dir(experiment_dir, checkpoint,
                       create_if_nonexistent=False):
    return _dir(os.path.join(experiment_dir, evaluation_subdir, checkpoint),
                create_if_nonexistent)


def get_reconstructed_mesh_filename(experiment_dir, epoch, dataset,
                                    class_name, instance_name):
    return os.path.join(experiment_dir, reconstructions_subdir, str(epoch),
                        reconstruction_meshes_subdir, dataset, class_name,
                        instance_name + ".ply")


def get_reconstructed_code_filename(experiment_dir, epoch, dataset,
                                    class_name, instance_name):
    return os.path.join(experiment_dir, reconstructions_subdir, str(epoch),
                        reconstruction_codes_subdir, dataset, class_name,
                        instance_name + ".pth")


def setup_dsdf(path: str, mode: str = "eval", precision="float32",
               device="cuda"):
    """Single-file convention (workspace.py:167-188): <name>.pt beside
    <name>.json -> (cfg, params on `device`, latent_size). 'float16' and
    'bfloat16' cast every parameter to bfloat16, as the JAX package maps
    the reference's fp16 (the decoder has no BatchNorm to keep in fp32)."""
    cfg, params = deepsdf.load_torch_checkpoint(path, device=device)
    if str(precision) in ("float16", "bfloat16"):
        params = deepsdf.cast_params(params, torch.bfloat16)
    return cfg, params, cfg.latent_size
