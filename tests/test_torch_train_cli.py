"""PyTorch port, the training CLI on the CPU:

- ``cli/args.py`` (the port's copy) maps a command line onto the same
  config as the JAX package's ``cli/args.py``;
- ``cli.train`` with ``--device cpu`` on two synthetic peptides (a tiny
  config: 2 layers, C = 48, 2 heads, a 2-head IPA encoder, L = 4, 8
  frames, B = 2, f32, ``--grad_checkpointing``, EMA): 2 steps, one
  validation batch; it writes ``config.json``, ``log.jsonl`` (2 train
  lines, 1 validation line, finite values), a ``torch.profiler`` trace
  (``--profile_dir``) and a checkpoint, from which ``cli.sim_inference``
  rolls out one window;
- ``--design --inference_batches 1``: 2 steps and the designability probe's
  ``designability_*`` line;
- the CLI's refusals before anything is written: ``--dp_size 2`` in one
  process (JAX's ``make_mesh`` ``ValueError``: a mesh of 2 needs 2 ranks),
  and the card by default without CUDA; the modular layer's flags and
  ``--dropout``, once refused, train 2 steps.
"""
import argparse
import json

import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.cli import args as jargs
from mdgen_finetune_tpu_torch.cli import args as targs
from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data, train

TINY = ["--sim_condition", "--prepend_ipa", "--abs_pos_emb", "--crop", "4", "--num_frames", "8",
        "--num_layers", "2", "--embed_dim", "48", "--mha_heads", "2", "--ipa_heads", "2",
        "--ipa_head_dim", "16", "--ipa_qk", "4", "--ipa_v", "4", "--suffix", "_i100",
        "--precision", "32-true", "--batch_size", "2", "--sampling_method", "heun",
        "--inference_steps", "2"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    synth_data.main(["--outdir", str(root / "data"), "--peptides", "AAGG", "GHKL",
                     "--num_frames", "20", "--suffix", "_i100"])
    return root


def _argv(root, *extra):
    split = str(root / "data" / "split.csv")
    return TINY + ["--data_dir", str(root / "data"), "--train_split", split, "--val_split", split,
                   "--workdir", str(root / "work"), *extra]


def test_args_map_to_the_jax_config(data):
    argv = _argv(data, "--grad_checkpointing", "--ema", "--lr", "3e-4", "--epochs", "7")
    configs = []
    for mod in (jargs, targs):
        p = argparse.ArgumentParser()
        mod.add_train_args(p)
        configs.append(mod.args_to_config(p.parse_args(argv)).to_json())
    assert configs[0] == configs[1]


def test_train_cli_trains_validates_and_checkpoints(data, capsys):
    state = train.main(_argv(data, "--grad_checkpointing", "--ema", "--epochs", "1",
                             "--steps_per_epoch", "2", "--val_batches", "1", "--print_freq", "1",
                             "--run_name", "run", "--device", "cpu",
                             "--profile_dir", str(data / "profile")))
    run = data / "work" / "run"
    assert state.step == 2
    assert json.loads((run / "config.json").read_text())["model"]["grad_checkpointing"]
    lines = [json.loads(x) for x in (run / "log.jsonl").read_text().splitlines()]
    assert [m.get("step") for m in lines] == [1, 2, 2] and "val_loss" in lines[-1]
    assert all(np.isfinite(v) for m in lines for v in m.values())
    assert json.loads((data / "profile" / "trace.json").read_text())["traceEvents"]
    ckpt = run / "ckpt_2"
    assert (ckpt / "state.pt").exists()
    capsys.readouterr()
    sim_inference.main(["--sim_ckpt", str(ckpt), "--data_dir", str(data / "data"),
                        "--split", str(data / "data" / "split.csv"), "--out_dir",
                        str(data / "sim"), "--num_rollouts", "1", "--suffix", "_i100",
                        "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["frames"] == 8 and (data / "sim" / f"{meta['name']}.pdb").exists()


@pytest.mark.parametrize("flags", [["--hyena"], ["--dropout", "0.1"], ["--dp_size", "2"],
                                   ["--interleave_ipa"], ["--no_rope"]])
def test_train_cli_refuses_unported_flags(data, flags):
    """``--dp_size 2`` in one process raises JAX's ``make_mesh``
    ``ValueError`` before anything is written (two ranks under torchrun:
    ``tests/test_torch_parallel.py``); the modular layer's flags and
    ``--dropout`` train: 2 steps with finite losses and a checkpoint."""
    name = "run_" + flags[0].strip("-")
    if flags[0] == "--dp_size":
        with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
            train.main(_argv(data, *flags, "--run_name", name, "--device", "cpu"))
        assert not (data / "work" / name).exists()
        return
    state = train.main(_argv(data, *flags, "--epochs", "1", "--steps_per_epoch", "2",
                             "--no_validate", "--print_freq", "1", "--run_name", name,
                             "--device", "cpu"))
    assert state.step == 2
    lines = [json.loads(x) for x in (data / "work" / name / "log.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [1, 2]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in lines)
    assert (data / "work" / name / "ckpt_2" / "state.pt").exists()


def test_train_cli_logs_designability(data):
    """``--design --inference_batches 1`` (the design preset's task flags):
    2 steps, then the designability probe samples a validation batch of 2
    and logs ``designability_*`` from the port's ``sequence_recovery``;
    the train and validation lines carry the design loss's parts."""
    argv = _argv(data, "--inpainting", "--design", "--no_torsion", "--inference_batches", "1",
                 "--epochs", "1", "--steps_per_epoch", "2", "--val_batches", "1",
                 "--print_freq", "1", "--run_name", "design", "--device", "cpu")
    argv.remove("--sim_condition")
    state = train.main(argv)
    assert state.step == 2
    lines = [json.loads(x) for x in (data / "work" / "design" / "log.jsonl").read_text()
             .splitlines()]
    probe = [m for m in lines if any(k.startswith("designability_") for k in m)]
    assert len(probe) == 1 and probe[0]["epoch"] == 0
    assert set(probe[0]) == {"epoch"} | {f"designability_{k}" for k in (
        "design_recovery", "cond_recovery", "max_design_recovery", "max_cond_recovery",
        "most_frequent_middle_recovery")}
    assert all(0.0 <= v <= 1.0 for k, v in probe[0].items() if k != "epoch")
    assert all("loss_discrete" in m and "loss_continuous" in m for m in lines[:2])
    assert "val_loss_discrete" in lines[-1] and "val_loss_continuous" in lines[-1]
    assert all(np.isfinite(v) for m in lines for v in m.values())


def test_train_cli_refuses_a_missing_card(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(_argv(data, "--run_name", "no_card"))  # --device defaults to cuda
    assert not (data / "work" / "no_card").exists()
