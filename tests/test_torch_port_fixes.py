"""Two faults of the port against the JAX package, each pinned: the FPN
head's logits conv in f32 under the trainer's bf16 autocast (as
rmem_tpu/models/decoders/fpn.py computes it), and the training CLI's
--exp_name, whose default puts a run where tools/eval.py looks for its
config."""

import os

import torch
import torch.nn.functional as F

from rmem_tpu_torch.models.decoders import fpn as fpn_mod
from rmem_tpu_torch.tools import eval as eval_cli
from rmem_tpu_torch.tools import train as train_cli


def test_fpn_logits_are_f32_under_bf16_autocast(monkeypatch):
    """Under CPU bf16 autocast the head's logits are f32 and equal the f32
    conv of the features that reach the logits conv."""
    torch.manual_seed(0)
    head = fpn_mod.FPNSegmentationHead(64, 3, decode_intermediate_input=False,
                                       hidden_dim=32,
                                       shortcut_dims=(8, 16, 24, 24))
    inputs = [torch.randn(1, 64, 5, 5)]
    shortcuts = [torch.randn(1, 8, 17, 17), torch.randn(1, 16, 9, 9),
                 torch.randn(1, 24, 5, 5), torch.randn(1, 24, 5, 5)]
    seen = []
    conv2d = F.conv2d

    def spy(x, w, *a, **kw):
        if w.shape[0] == 3:                 # the logits conv
            seen.append(x.detach().clone())
        return conv2d(x, w, *a, **kw)

    monkeypatch.setattr(fpn_mod.F, "conv2d", spy)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        logits = head(inputs, shortcuts)
    assert logits.dtype == torch.float32
    (x,) = seen
    with torch.no_grad():
        ref = conv2d(x.float(), head.conv_out.weight.float(),
                     head.conv_out.bias.float())
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)


def test_train_cli_exp_name_meets_eval_cli(tmp_path, capsys):
    """One step of `tools/train.py` with its default --exp_name (rmem)
    writes config.json where `tools/eval.py`, with its default, reloads
    it."""
    opts = ["--opt", f"dir_root={tmp_path}", "data_randomcrop=(33, 33)"]
    train_cli.main(["--stage", "test", "--model", "tiny_deaotl", "--device",
                    "cpu", "--max_steps", "1", *opts])
    (run,) = os.listdir(tmp_path)
    assert run.startswith("rmem_")
    assert os.path.isfile(os.path.join(tmp_path, run, "test",
                                       "config.json"))
    capsys.readouterr()
    eval_cli.main(["--stage", "test", "--model", "tiny_deaotl", "--dataset",
                   "test", "--device", "cpu", "--max_frames", "2",
                   "--max_seqs", "1", "--output_root",
                   str(tmp_path / "masks"), *opts])
    out = capsys.readouterr().out
    assert "reloading saved training config" in out
    assert os.path.join(run, "test", "config.json") in out
