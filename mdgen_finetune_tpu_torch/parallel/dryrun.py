"""The port's multi-rank dry run: the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip`` (:47).

    python -m mdgen_finetune_tpu_torch.parallel.dryrun 4 cuda
    python -m mdgen_finetune_tpu_torch.parallel.dryrun 4 cpu

``dryrun_multichip(n_ranks, device)`` spawns ``n_ranks`` processes
(``launch.run``: ``gloo`` on the CPU and when ranks share a card, ``nccl``
when each has its own) and runs, on an n-rank (dp, sp) mesh (sp = 2 when
n is even, dp = n / sp):

1. one full training step of the flagship config (5 x 384, 16 heads,
   prepend-IPA 4 x 32, ``abs_pos_emb``, ``sim_condition``; T = 32 sp,
   L = 4, B = dp: the batch over dp, the trunk sequence-split over sp),
   asserting that it all-reduced and, with sp > 1, that it swapped
   (all-to-all) and gathered;
2. the B = 1, crop-64, T = 8 sp forward of the same width under the whole
   mesh (``kernel_mesh``: the trunk's frames and residues split over every
   rank), asserting that it communicated and is finite.

It prints JAX's two "dryrun_multichip OK" lines, with the port's collective
counts (``parallel/comm.py``) where JAX counts its compiled HLO's. f32 on
the CPU, the config's bf16 on the card. The device is the card unless the
CPU is asked for; without CUDA the card raises.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..inference.sampling import resolve_device
from . import comm, launch


def _rank(n: int, device: str) -> list:
    from ..config import DataConfig, MDGenConfig, ModelConfig, TaskConfig, TrainConfig
    from ..data.synthetic import synthesize_trajectory
    from ..geometry.rigid import Rigid
    from ..models.denoiser import LatentMDGen
    from ..training import Trainer
    from .kernel_sharding import kernel_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.distributed.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    f32 = dev.type == "cpu"
    sp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // sp
    B, T, L = dp, 32 * sp, 4
    cfg = MDGenConfig(model=ModelConfig(prepend_ipa=True, abs_pos_emb=True, use_bf16=not f32),
                      data=DataConfig(num_frames=T, crop=L), task=TaskConfig(sim_condition=True),
                      train=TrainConfig(batch_size=B, dp_size=dp, sp_size=sp, ema=True))
    trainer = Trainer(cfg, device=dev)
    mesh = trainer.mesh
    batch = {"atom14": np.stack([synthesize_trajectory("AAGH", T, seed=i).astype(np.float32)
                                 for i in range(B)]),
             "seqres": np.tile(np.array([0, 0, 7, 6], np.int64), (B, 1)),
             "mask": np.ones((B, L), np.float32)}
    state = trainer.init_state(0)
    comm.reset()
    state, metrics = trainer.train_step(state, batch, torch.Generator(device=dev).manual_seed(1))
    loss = float(metrics["loss"])
    n_allreduce = comm.COUNTS["all_reduce"]
    n_reshard = comm.COUNTS["all_to_all"] + comm.COUNTS["all_gather"]
    assert n_allreduce > 0, "no all-reduce in the train step (dp axis dead?)"
    if sp > 1:
        assert comm.COUNTS["all_to_all"] > 0 and comm.COUNTS["all_gather"] > 0, \
            f"no resharding collective in the train step (sp axis dead?): {comm.COUNTS}"
    assert np.isfinite(loss), f"non-finite loss {loss}"
    lines = [f"dryrun_multichip OK: mesh dp={dp} sp={sp}, flagship 5x384 T={T}, "
             f"loss={loss:.4f}, collectives: all-reduce={n_allreduce} reshard={n_reshard}"]

    B2, T2, L2 = 1, 8 * sp, 64
    cfg2 = MDGenConfig(model=ModelConfig(prepend_ipa=True, abs_pos_emb=True, use_bf16=not f32),
                       data=DataConfig(num_frames=T2, crop=L2), task=TaskConfig(sim_condition=True))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        model2 = LatentMDGen(cfg2, cfg2.latent_dim,
                             dtype=torch.float32 if f32 else torch.bfloat16).to(dev)
    rng = np.random.default_rng(0)
    x2 = torch.as_tensor(rng.normal(size=(B2, T2, L2, cfg2.latent_dim)), dtype=torch.float32,
                         device=dev)
    frames = Rigid.identity((B2, L2), device=dev)
    comm.reset()
    with kernel_mesh(mesh):
        out2 = model2.forward_inference(
            x2, torch.full((B2,), 0.5, device=dev), torch.ones(B2, T2, L2, device=dev),
            start_frames=frames, end_frames=frames, x_cond=torch.zeros_like(x2),
            x_cond_mask=torch.zeros(B2, T2, L2, dtype=torch.long, device=dev),
            aatype=torch.zeros(B2, L2, dtype=torch.long, device=dev))
    n_coll2 = sum(comm.COUNTS.values())
    if n > 1:
        assert n_coll2 > 0, "B=1 large-L forward ran with no collectives"
    assert torch.isfinite(out2).all(), "non-finite B=1 large-L output"
    lines.append(f"dryrun_multichip OK: B={B2} < n_devices={n} large-L "
                 f"(crop {L2}, T={T2}) forward, collectives={n_coll2}")
    return lines


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> list:
    """Run the dry run on ``n_ranks`` spawned ranks (module docstring);
    print and return rank 0's two lines."""
    backend = "gloo"
    if resolve_device(device).type == "cuda" and n_ranks <= torch.cuda.device_count():
        backend = "nccl"
    lines = launch.run(_rank, n_ranks, n_ranks, device, backend=backend)[0]
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
