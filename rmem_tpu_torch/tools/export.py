"""Export the fused serving step with `torch.export` as a `.pt2` artifact.

Counterpart of `rmem_tpu/tools/export.py`, for every config its
`build_exported` takes. The step is `InferenceEngine.functional_step`:
propagate the frame against the bank, upsample and take the label, then
write the frame's memories (the long-term write decided by a bool flag
given as an input):

    (*state, img [1, H, W, 3] f32, write_flag bool) -> (*new_state,
                                                        label [H, W] int32)

with the state's tensors in the order of the engine's `state_fields()`:
`InferenceEngine.STATE_FIELDS`, less the record with `no_long_memory`
(which writes only the short-term memory and does not read the flag),
then the ConvGRU memory's hidden states with `gru_memory` (whose write is
a `torch.cond` on the flag, its eviction round decided from the bank's
count on the device). The example state is `add_reference` on a blank
frame; any state of the same shapes works, a full bank's too. The caller
keeps the write schedule (`InferenceEngine.write_due` gives the flag the
live engine would take).

The kernels are in the graph as the custom ops of
`rmem_tpu_torch/kernels/ops.py` (rmem::bank_attention_infer,
rmem::local_attention, rmem::stem, ...): unlike the JAX package's
StableHLO, the artifact needs `rmem_tpu_torch.kernels.ops` imported to
resolve them before `torch.export.load`, and runs them on the device its
tensors are on (the CUDA kernels on the card, their plain versions on the
CPU).

    python -m rmem_tpu_torch.tools.export --stage pre_vost \\
        --model r50_deaotl --hw 481 849 --out step.pt2 [--ckpt w.pth]
    python -m rmem_tpu_torch.tools.export --model r50_aotl \\
        --out step.pt2 --opt gru_memory=true
    python -m rmem_tpu_torch.tools.export --stage test \\
        --model tiny_deaotl --hw 33 33 --out step.pt2 --device cpu

It runs on the card unless --device cpu is given (f32 activations there).
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch
import torch.nn as nn


class ExportedStep(nn.Module):
    """The engine's functional step at a fixed output size, as a module
    whose parameters are the engine's model's."""

    def __init__(self, engine, out_hw: Tuple[int, int]):
        super().__init__()
        self.model = engine.model
        self._engine = engine
        self.out_hw = tuple(out_hw)

    def forward(self, *args):
        *state, img, write_flag = args
        new_state, label = self._engine.functional_step(
            state, img, write_flag, self.out_hw)
        return (*new_state, label)


def build_exported(cfg, params: Optional[dict] = None, hw=(481, 849),
                   groups: int = 1, device=None, out_hw=None):
    """(torch.export.ExportedProgram, example state tensors, params) of the
    fused step at hw with `groups` id groups, its label at out_hw (default
    hw), on the card unless `device` says otherwise. `params` is a state
    dict of the model (default init_params(seed 0)); the engine folds and
    casts it for a bf16 config."""
    from rmem_tpu_torch.engine.inference import InferenceEngine
    from rmem_tpu_torch.kernels import ops  # noqa: F401 (registers the ops)
    from rmem_tpu_torch.models import build_vos_model, init_params

    model = build_vos_model(cfg.model_vos, cfg)
    if params is None:
        init_params(model, 0)
    else:
        model.load_state_dict(params, strict=True)
    engine = InferenceEngine(model, cfg, device=device)
    dev = engine.device
    hw = tuple(hw)
    img0 = torch.zeros((1, *hw, 3), dtype=torch.float32, device=dev)
    mask0 = torch.zeros((groups, *hw), dtype=torch.int32, device=dev)
    state, _ = engine.add_reference(img0, mask0,
                                    [cfg.model_max_obj_num] * groups, gap=5)
    example = tuple(t.clone() for t in engine.state_tensors(state))
    flag = torch.tensor(True, device=dev)
    with torch.no_grad():
        exported = torch.export.export(ExportedStep(engine, out_hw or hw),
                                       (*example, img0, flag))
    return exported, example, engine.model.state_dict()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage", default="pre_vost")
    ap.add_argument("--model", default="r50_deaotl")
    ap.add_argument("--hw", type=int, nargs=2, default=(481, 849))
    ap.add_argument("--groups", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help=".pth, msgpack or this package's weights")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    ap.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides, e.g. --opt gru_memory=true")
    args = ap.parse_args(argv)

    from rmem_tpu_torch.config import get_config
    from rmem_tpu_torch.tools.train import _parse_opts
    over = {"compute_dtype": "float32"} if args.device == "cpu" else {}
    over.update(_parse_opts(args.opt))
    cfg = get_config(args.stage, model=args.model, **over)
    params = None
    if args.ckpt:
        from rmem_tpu_torch.models import build_vos_model, load_model_params
        model = build_vos_model(cfg.model_vos, cfg)
        load_model_params(model, args.ckpt)
        params = model.state_dict()
    exported, _, _ = build_exported(cfg, params, tuple(args.hw), args.groups,
                                    device=args.device)
    torch.export.save(exported, args.out)
    ops = sorted({str(n.target) for n in exported.graph.nodes
                  if str(n.target).startswith("rmem.")})
    print(f"wrote {args.out} (custom ops: {', '.join(ops) or 'none'})")


if __name__ == "__main__":
    main()
