"""Rank bodies for the port's rays-axis and data-axis tests on gloo
(tests/test_torch_rays.py, tests/test_torch_sharded_refine.py,
tests/test_torch_driver_mesh.py).

Each function runs as one rank of parallel/mesh.py::spawn_ranks (a fresh
process in a gloo process group; it imports torch and the port only),
runs every job it was given and pickles what it saw to
``<out>/<name>_<rank>.pkl`` for the parent test (torch_dp_worker.load).
"""

import numpy as np
import torch

from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.parallel import rays as trays
from sdflabel_tpu_torch.parallel import sharded_refine as tshard
from torch_dp_worker import _dump, _share_cores


def sphere_decoder(latent, pts):
    """The sphere of tests/test_sharded_refine.py::_sphere_decoder."""
    return torch.linalg.norm(pts, dim=-1) - (0.45 + 0.1 * latent[..., :1])


def sphere2_decoder(latent, pts):
    """The sphere of test_sharded_gradient_parity_per_loss_path, whose
    radius reads two latent coordinates."""
    r = 0.45 + 0.1 * latent[..., :1] + 0.05 * latent[..., 1:2]
    return torch.linalg.norm(pts, dim=-1) - r


def bf16_twin(latent, pts):
    """A bf16 selection decoder of sphere_decoder, as JAX's test's."""
    return sphere_decoder(latent.bfloat16(), pts.bfloat16()).float()


DECODERS = {"sphere": sphere_decoder, "sphere2": sphere2_decoder,
            "bf16": bf16_twin}


def _params(p0):
    return tref.RefineParams(*(torch.as_tensor(np.asarray(v, np.float32))
                               for v in p0))


def _numpy(params):
    return [p.detach().numpy().copy() for p in params]


def sharded_rank(rank, out, jobs):
    """make_sharded_refine_fn on the rays axis of all the ranks, for each
    job {name, decoder, select, cfg, windowed_2d, grid, K, crop_hw, init,
    nocs, frustum, fmask}: the final parameters and the loss history."""
    world = torch.distributed.get_world_size()
    mesh = mesh_mod.make_mesh(1, world)
    _share_cores(world)
    res = {}
    for job in jobs:
        fn = tshard.make_sharded_refine_fn(
            DECODERS[job["decoder"]], tref.RefineConfig(**job["cfg"]),
            torch.as_tensor(job["grid"]), job["K"], job["crop_hw"], mesh,
            windowed_2d=job.get("windowed_2d"),
            select_decoder=DECODERS.get(job.get("select")), device="cpu")
        final, hist = fn(_params(job["init"]), torch.as_tensor(job["nocs"]),
                         torch.as_tensor(job["frustum"]),
                         torch.as_tensor(job["fmask"]))
        res[job["name"]] = {"final": _numpy(final),
                            "hist": hist.numpy().copy()}
    _dump(out, "sharded", rank, res)


def rays_rank(rank, out, jobs):
    """make_rays_sharded_render on the rays axis of all the ranks, for each
    job {K, res, pts, normals, pose, mask}: the image, and the gradients
    of sum(image^2) in the pose and the points."""
    world = torch.distributed.get_world_size()
    mesh = mesh_mod.make_mesh(1, world)
    _share_cores(world)
    res = []
    for job in jobs:
        render = trays.make_rays_sharded_render(mesh, job["K"], job["res"])
        pose = torch.as_tensor(job["pose"]).requires_grad_(True)
        pts = torch.as_tensor(job["pts"]).requires_grad_(True)
        img = render(pts, torch.as_tensor(job["normals"]), pose,
                     torch.as_tensor(job["mask"]))
        img.square().sum().backward()
        res.append({"img": img.detach().numpy(), "g_pose": pose.grad.numpy(),
                    "g_pts": pts.grad.numpy()})
    _dump(out, "rays", rank, res)


def _stub_pose(self, *args, **kwargs):
    """tests/test_driver_mesh.py's pose: every crop starts from it."""
    return {"scale": 4.0, "rot": np.eye(3), "tra": np.array([0.5, 1.6, 12.0])}


def mlp_sphere_decoder(spec, params):
    """test_torch_batched_refine.py's decoder: a DeepSDF MLP of the latent
    bending a sphere of radius .45."""
    from sdflabel_tpu_torch.models import deepsdf as tds

    mlp = tds.sdf_fn(tds.DeepSDFConfig(**spec), tds.params_from_jax(params))

    def dec(lat, p):
        return torch.linalg.norm(p, dim=-1) - 0.45 + 0.1 * mlp(lat, p)

    return dec


def driver_mesh_rank(rank, out, ini, batch_job):
    """On a (data=2, rays=1) mesh of the two ranks: refine_css(mesh=) on the
    KITTI tree of the `ini` sections (every pose stubbed), then, on rank 0
    alone, the same driver without a mesh into other dumps; then
    make_batched_refine(mesh=) on `batch_job`'s lanes."""
    import configparser

    from sdflabel_tpu_torch.parallel import batched_refine as tbr
    from sdflabel_tpu_torch.pipelines import refine_css as tpipe

    mesh = mesh_mod.make_mesh(2, 1)
    _share_cores(mesh.size)
    tpipe.RefineRuntime.estimate_pose = _stub_pose
    res = {}
    for labels, run_mesh in (("lab_mesh", mesh), ("lab_single", None)):
        if run_mesh is None and rank:
            break
        cfgp = configparser.ConfigParser()
        cfgp.read_dict(ini)
        cfgp.set("output", "labels", f"{out}/{labels}")
        res[labels] = tpipe.refine_css(cfgp, batched=True, device="cpu",
                                       mesh=run_mesh)
    job = batch_job
    fn = tbr.make_batched_refine(
        mlp_sphere_decoder(job["spec"], job["params"]),
        tref.RefineConfig(**job["cfg"]), torch.as_tensor(job["grid"]),
        job["bucket"], with_extents=True, mesh=mesh, device="cpu")
    p0, *rest = job["batch"]
    final, hist, ext = fn(tref.RefineParams(**{
        f: torch.as_tensor(v) for f, v in p0.items()}),
        *map(torch.as_tensor, rest))
    res["batched"] = (final, hist, ext)
    _dump(out, "driver_mesh", rank, res)


def card_rank(rank, out, job):
    """On the card and then on the CPU, the same work on the rays axis of
    the two ranks (both on cuda:0 on the card): the rays render with the
    gradients of sum(image^2), and one sharded refine step through an
    sphere bent by an 8x128 DeepSDF, whose selection decoder takes the
    selection kernel for the DeepSDF; with
    the launches of kernels 1a, 1b, 2 and 3 and of the binned trio (the
    bins, 1c, 1d) on this rank."""
    from sdflabel_tpu_torch.models import deepsdf as tds
    from sdflabel_tpu_torch.ops import grid as tgrid
    from sdflabel_tpu_torch.ops import mlp_cuda, nn_cuda, splat_cuda

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_mod.make_mesh(1, 2)
    _share_cores(2)
    counters = {"splat_fwd": splat_cuda.SPLAT_FWD,
                "splat_bwd": splat_cuda.SPLAT_BWD, "nn": nn_cuda.NN_FWD,
                "select_mlp": mlp_cuda.SELECT_MLP,
                "splat_bins": splat_cuda.SPLAT_BINS,
                "splat_fwd_binned": splat_cuda.SPLAT_FWD_BINNED,
                "splat_bwd_binned": splat_cuda.SPLAT_BWD_BINNED}
    res = {}
    for dev in ("cuda", "cpu"):
        for c in counters.values():
            c.launches = 0
        render = trays.make_rays_sharded_render(mesh, job["K"], job["res"])
        pose = torch.as_tensor(job["pose"], device=dev).requires_grad_(True)
        pts = torch.as_tensor(job["pts"], device=dev).requires_grad_(True)
        img = render(pts, torch.as_tensor(job["normals"], device=dev), pose,
                     torch.as_tensor(job["mask"], device=dev))
        img.square().sum().backward()
        cfg = tds.DeepSDFConfig(**job["spec"])
        params = tds.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
        mlp = tds.sdf_fn(cfg, params)
        kernel = mlp_cuda.select_fn(cfg, params)

        def dec(lat, p, mlp=mlp):  # the MLP bends a sphere of radius .45
            return torch.linalg.norm(p, dim=-1) - 0.45 + 0.1 * mlp(lat, p)

        def sel(lat, p, kernel=kernel):
            return torch.linalg.norm(p, dim=-1) - 0.45 + 0.1 * kernel(lat, p)

        fn = tshard.make_sharded_refine_fn(
            dec, tref.RefineConfig(**job["cfg"]),
            tgrid.generate_point_grid(job["density"]), job["crop_K"],
            job["crop_hw"], mesh, select_decoder=sel, device=dev)
        final, hist = fn(_params(job["init"]),
                         *(torch.as_tensor(job[k]) for k in ("nocs",
                                                             "frustum",
                                                             "fmask")))
        res[dev] = {"img": img.detach().cpu().numpy(),
                    "g_pose": pose.grad.cpu().numpy(),
                    "g_pts": pts.grad.cpu().numpy(),
                    "final": [p.cpu().numpy() for p in final],
                    "hist": hist.cpu().numpy(),
                    "launches": {k: c.launches
                                 for k, c in counters.items()}}
    _dump(out, "card", rank, res)
