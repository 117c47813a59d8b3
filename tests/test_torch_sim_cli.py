"""PyTorch port, the forward-simulation CLI and its PDB writer on the CPU:

- ``cli.synth_data`` writes a peptide; a ``Trainer`` checkpoint of seeded
  random weights is saved; ``cli.sim_inference`` rolls out 2 windows from
  it with ``--device cpu`` and writes a multi-MODEL PDB that parses back
  (``from_pdb_models``) to 2 * num_frames models with ideal backbone bonds,
  and its meta JSON line;
- the CLI's refusal of the card by default without CUDA, and ``--sde``
  with Euler-Maruyama and with Heun on the CPU (a trajectory with ideal
  bonds);
- ``atom14_to_pdb``: the same text as the JAX package's writer for the
  same arrays.

Sizes: 2 layers, C = 48, 2 heads, a 2-head IPA encoder, L = 4, 8 frames per
window, Heun with 2 steps, f32. Bonds within 1e-2 Angstrom of 1.458 (N-CA)
and 1.522 (CA-C), the PDB's 3 decimals included.
"""
import json

import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.geometry import protein as jprotein
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import sim_inference, synth_data
from mdgen_finetune_tpu_torch.geometry import protein as tprotein
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.weights import randomize_

T, L = 8, 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("sim_cli")
    synth_data.main(["--outdir", str(root / "data"), "--peptides", "AAGG", "--num_frames", "20",
                     "--suffix", "_i100"])
    cfg = tcfg.preset_4aa_sim(
        model=tcfg.ModelConfig(num_layers=2, embed_dim=48, mha_heads=2, ipa_heads=2,
                               ipa_head_dim=16, ipa_qk=4, ipa_v=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        transport=tcfg.TransportConfig(sampling_method="heun", inference_steps=2),
        workdir=str(root))
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    randomize_(trainer.model, torch.Generator().manual_seed(1), scale=0.05)
    ckpt = trainer.save_checkpoint(state, str(root / "ckpt"))
    args = ["--sim_ckpt", ckpt, "--data_dir", str(root / "data"),
            "--split", str(root / "data" / "split.csv"), "--out_dir", str(root / "out"),
            "--num_frames", str(T), "--num_rollouts", "2", "--suffix", "_i100"]
    return root, args


def test_sim_inference_cli_writes_a_trajectory(run, capsys):
    root, args = run
    sim_inference.main(args + ["--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["name"] == "AAGG" and meta["frames"] == 2 * T
    assert json.loads((root / "out" / "AAGG_meta.json").read_text()) == meta
    path = str(root / "out" / "AAGG.pdb")
    models = tprotein.from_pdb_models(path)
    assert len(models) == 2 * T
    aatype = np.array([0, 0, 7, 7])  # AAGG
    for aat, xyz in models:
        np.testing.assert_array_equal(aat, aatype)
        assert np.isfinite(xyz).all()
    chunks = [c for c in open(path).read().split("ENDMDL") if "ATOM" in c]
    pos = np.stack([tprotein.from_pdb_string(c).atom_positions for c in chunks])  # (2T, L, 37, 3)
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2


@pytest.mark.parametrize("extra, error", [([], RuntimeError), (["--sde"], None),
                                          (["--sde", "--sde_method", "Heun"], None)])
def test_sim_inference_cli_refusals(run, monkeypatch, capsys, extra, error):
    """Without CUDA the default device raises; with ``--device cpu`` the
    SDE sampler runs with either of its methods (3 steps) and writes a
    trajectory with ideal backbone bonds (released checkpoints load:
    ``tests/test_torch_reference_ckpt.py``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, args = run
    if error is not None:
        with pytest.raises(error, match="CUDA is not available"):
            sim_inference.main(args + extra)
        return
    out = root / ("sde_" + extra[-1])
    sim_inference.main(args[:args.index("--out_dir")] + ["--out_dir", str(out)]
                       + args[args.index("--out_dir") + 2:] + extra
                       + ["--sde_steps", "3", "--device", "cpu"])
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["name"] == "AAGG" and meta["frames"] == 2 * T
    chunks = [c for c in open(out / "AAGG.pdb").read().split("ENDMDL") if "ATOM" in c]
    pos = np.stack([tprotein.from_pdb_string(c).atom_positions for c in chunks])
    assert pos.shape[:2] == (2 * T, L) and np.isfinite(pos).all()
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    ca_c = np.linalg.norm(pos[:, :, 1] - pos[:, :, 2], axis=-1)
    assert np.abs(n_ca - 1.458).max() < 1e-2 and np.abs(ca_c - 1.522).max() < 1e-2


def test_atom14_to_pdb_text_matches_jax_writer(tmp_path):
    rng = np.random.default_rng(0)
    atom14 = (rng.normal(size=(3, L, 14, 3)) * 5).astype(np.float32)
    aatype = np.array([0, 5, 7, 19])
    jprotein.atom14_to_pdb(atom14, aatype, str(tmp_path / "jax.pdb"))
    tprotein.atom14_to_pdb(atom14, aatype, str(tmp_path / "torch.pdb"))
    text = (tmp_path / "torch.pdb").read_text()
    assert text == (tmp_path / "jax.pdb").read_text()
    assert len(tprotein.from_pdb_models(str(tmp_path / "torch.pdb"))) == 3
