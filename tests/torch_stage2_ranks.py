"""One rank of tests/test_torch_stage2_parallel.py's data-parallel stage-2
run, in a module that imports no JAX, so that the spawned ranks start
quickly (pytest collects only test_*.py files)."""
import os

import torch


def worker(rank, world, port, inputs, out_dir):
    """The cluster centres seeded from the global first batch on rank 0 and
    broadcast (into a copy of the head), then the port's stage-2 steps on
    this rank's items of each global batch, with the global draws' rows;
    writes the centres, the reduced losses, the averaged gradients of the
    first step and the head and buffers after each step."""
    from scenedino_torch.models.downstream import SemanticHead, SemanticHeadConfig
    from scenedino_torch.models.factory import make_model
    from scenedino_torch.parallel.data_parallel import DataParallel
    from scenedino_torch.renderer.nerf import RenderConfig
    from scenedino_torch.training import downstream as down

    torch.set_num_threads(1)
    dp = DataParallel.init(rank, world, torch.device("cpu"), init_method=f"tcp://localhost:{port}")
    try:
        data = torch.load(inputs, weights_only=False)
        model = make_model(data["model"], device="cpu", training=True)
        model.load_state_dict(data["field"])
        model.eval().requires_grad_(False)
        head = SemanticHead(SemanticHeadConfig(**data["head_cfg"]))
        head.load_state_dict(data["head"])
        cfg, rcfg = down.DownstreamTrainConfig(**data["cfg"]), RenderConfig(n_coarse=data["n_coarse"])
        seeded = SemanticHead(SemanticHeadConfig(**data["head_cfg"]))
        seeded.load_state_dict(data["head"])

        def first_batch():
            assert dp.main, "only rank 0 reads the first batch"
            return data["seed_batch"]

        down.seed_cluster_centers_everywhere(model, seeded, first_batch, data["seed_draws"], cfg, rcfg, dp)
        out = {"losses": [], "params": [], "buffers": [],
               "centers": [m.cluster_centers.clone() for m in (seeded.direct_cluster_head, seeded.stego_cluster_head)]}
        state = down.init_downstream_state(head, cfg)
        step = down.make_downstream_train_step(model, head, cfg, rcfg, dp=dp)
        for batch, draws in zip(data["batches"], data["draws"]):
            n = batch["imgs"].shape[0]
            mine = {k: v[dp.rows(n)] for k, v in batch.items()}
            losses = step(state, mine, down.shard_stage2_draws(draws, dp, n, head, cfg))
            out["losses"].append({k: float(v) for k, v in dp.reduce_losses(losses).items()})
            if "grads" not in out:
                out["grads"] = {k: p.grad.clone() for k, p in head.named_parameters()}
            out["params"].append({k: p.detach().clone() for k, p in head.named_parameters()})
            b = state.buffers
            out["buffers"].append((b.patch_buffer.clone(), b.gap_buffer.clone(), b.idx, b.filled))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
