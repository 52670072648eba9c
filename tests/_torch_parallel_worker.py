"""Worker of tests/test_torch_port_parallel.py: one rank of a two-process
gloo group on the CPU (RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT in
its environment, as a launcher sets them), or the one-process reference
without them.

Usage: python _torch_parallel_worker.py MODE OUTDIR [MODEL]

MODE train: 3 Trainer steps of tiny_deaotl f32 with SGD at global batch
2 (one clip a rank), the loss of each step and the weights after to
OUTDIR.
MODE eval / eval_claim: the Evaluator over the synthetic `test` set
(max_frames 4), its sequences shared by length (eval_claim: the shortest
claimed at run time through OUTDIR/claims), the stats to OUTDIR.
MODE tp: 2 Trainer steps of MODEL (default tiny_deaotl) on a (1, 2)
("data", "model") mesh (the self-attention split across the two ranks), as
train, the weights whole.
"""

import itertools
import json
import os
import sys


def main():
    mode, outdir = sys.argv[1], sys.argv[2]
    model = sys.argv[3] if len(sys.argv) > 3 else "tiny_deaotl"
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.parallel import maybe_initialize_distributed
    from rmem_tpu_torch.parallel.eval_sharding import rank

    distributed = maybe_initialize_distributed(device="cpu")
    tag = f"r{rank()}" if distributed else "one"
    if mode in ("train", "tp"):
        from rmem_tpu_torch.managers.trainer import Trainer
        hw, steps = (33, 33), 3 if mode == "train" else 2
        over = {}
        if distributed:
            over = (dict(mesh_shape=(1, 2), mesh_axes=("data", "model"))
                    if mode == "tp" else dict(mesh_shape=(-1,)))
        cfg = get_config("test", model=model, train_total_steps=100,
                         compute_dtype="float32", train_opt="sgd", **over)
        rng = np.random.RandomState(0)
        labels = np.zeros((2, 2, *hw), np.int32)
        labels[:, :, 12:30, 12:30] = 1
        batch = {"imgs": torch.from_numpy(
                     rng.rand(2, 2, *hw, 3).astype(np.float32)),
                 "labels": torch.from_numpy(labels),
                 "obj_nums": torch.tensor([1, 1], dtype=torch.int32)}
        trainer = Trainer(cfg, device="cpu", seed=0, log=lambda *a: None,
                          batches=itertools.repeat(batch))
        losses = [trainer.train(max_steps=1)["loss"] for _ in range(steps)]
        params = {n: p.numpy() for n, p in trainer._whole(
            {n: p.detach() for n, p in
             trainer.state.model.named_parameters()}).items()}
        np.savez(os.path.join(outdir, f"params_{tag}.npz"), **params)
        split = getattr(trainer.state.model, "tp_split", None)
        result = {"losses": losses,
                  "split": 0 if split is None else len(split.index)}
    else:
        from rmem_tpu_torch.managers.evaluator import Evaluator
        from rmem_tpu_torch.models import build_vos_model, init_params
        cfg = get_config("test", model="tiny_deaotl", test_dataset="test",
                         test_ckpt_path="test", compute_dtype="float32")
        model = build_vos_model(cfg.model_vos, cfg)
        init_params(model, 0)
        ev = Evaluator(cfg, params=model.state_dict(), device="cpu",
                       output_root=os.path.join(outdir, f"masks_{tag}"),
                       log=lambda *a: None)
        kw = (dict(claim_dir=os.path.join(outdir, "claims"), tail_frac=0.4)
              if mode == "eval_claim" else {})
        stats = ev.evaluate(max_frames=4, **kw)
        result = {"stats": {k: v for k, v in stats.items()
                            if k != "per_seq_fps"},
                  "seq_names": sorted(stats["per_seq_fps"])}
    with open(os.path.join(outdir, f"{tag}.json"), "w") as f:
        json.dump(result, f)
    if distributed:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
