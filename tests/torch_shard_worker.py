"""One rank of the port's sharded renders on the CPU (gloo), for
``tests/test_torch_shard.py``: ``run`` is the function that
``torch.multiprocessing.spawn`` starts in each process.  It imports no JAX,
so a rank starts in a second or two."""
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

CORNELL = Path(__file__).resolve().parent.parent / "scenes" / "cornell.txt"
W, H = 16, 12        # 192 lanes: 2, 3 and 4 ranks split them evenly
CFG = dict(width=W, height=H, eye_depth=2, light_depth=2, delta_budget=2)
PT_SPP, BDPT_SPP, BDPT_SPL, PPM_SPL, K = 4, 2, 4, 512, 8
SEED = 0


def setup(device="cpu"):
    """(scene, camera, config, key) of the sharded cases."""
    from path_tracing_tpu_torch.config import RenderConfig
    from path_tracing_tpu_torch.ops import rng
    from path_tracing_tpu_torch.scene.camera import make_camera
    from path_tracing_tpu_torch.scene.parser import load_scene

    p = load_scene(str(CORNELL))
    cam = make_camera(p.eye, p.look_at, p.view_up, p.fov, W, H,
                      device=device)
    return p.to_device(device), cam, RenderConfig(**CFG), rng.prng_key(SEED)


def cases(scene, cam, cfg, key, mesh):
    """Every sharded render the tests hold, by name."""
    from path_tracing_tpu_torch.parallel import shard

    ris = cfg.with_(bdpt_resample_vertices=K)
    return {
        "pt": shard.render_pt_sharded(scene, cam, W, H, PT_SPP, cfg, key,
                                      mesh),
        "bdpt_fused_ris": shard.render_bdpt_sharded(
            scene, cam, W, H, BDPT_SPP, BDPT_SPL, ris, key, mesh,
            tier="fused"),
        "bdpt_mega_exact": shard.render_bdpt_sharded(
            scene, cam, W, H, BDPT_SPP, BDPT_SPL, cfg, key, mesh),
        "bdpt_mega_tile_ris": shard.render_bdpt_sharded(
            scene, cam, W, H, BDPT_SPP, BDPT_SPL, ris, key, mesh,
            tier="mega"),
        "ppm": shard.render_ppm_sharded(scene, cam, W, H, PPM_SPL, cfg, key,
                                        mesh),
        "ppm_hash": shard.render_ppm_sharded(scene, cam, W, H, PPM_SPL, cfg,
                                             key, mesh, tier="hash"),
    }


def run(rank: int, world: int, port: int, dcn: int, out_dir: str) -> None:
    """Render every case on a ``world``-rank gloo mesh (``dcn`` rows) and
    write this rank's images and mesh index to ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        from path_tracing_tpu_torch.parallel import shard

        mesh = shard.make_mesh(world, dcn=dcn, backend="gloo")
        out = {k: v.numpy() for k, v in cases(*setup(), mesh).items()}
        out["linear_index"] = np.int64(shard._linear_index(mesh))
        out["mesh_names"] = np.array(mesh.mesh_dim_names)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
