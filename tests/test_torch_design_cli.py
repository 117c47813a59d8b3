"""The port's design CLIs on the CPU.

- ``design_inference --torch_ckpt`` on a 300-frame synthetic "AGHK"
  trajectory (``inpainting + design``, no ``--random_start_idx``) writes 2
  samples; their states and window starts are those that the JAX package's
  ``build_msm_metadata`` + ``pick_flux_states(..., "max")`` and
  ``np.random.default_rng(seed)`` pick, each PDB has T models with the
  peptide's own sequence, and ``aa_out`` is (T, L) in 0..19 with the
  conditioning residues' sequence read from the model.
- ``analyze_design`` prints ``design_recovery`` per peptide and a ``MEAN``
  line, as ``sequence_recovery`` (held to the JAX package's) computes it.
- Without CUDA and without ``--device cpu`` the CLI raises before writing.

Sizes: 1 layer, C = 32, 4 heads, a 2-head IPA of widths (8, 4, 4), L = 4,
T = 8, 2 Euler steps, f32.
"""
import json

import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.analysis.task_metrics import sequence_recovery as j_sequence_recovery
from mdgen_finetune_tpu.cli import msm_common as jmsm
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.analysis import sequence_recovery
from mdgen_finetune_tpu_torch.cli import analyze_design, design_inference, synth_data
from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.utils.torch_compat import write_reference_checkpoint
from mdgen_finetune_tpu_torch.utils.weights import randomize_

T, L, SEED = 8, 4, 137


def _cfg():
    return tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2,
                               ipa_head_dim=8, ipa_qk=4, ipa_v=4, prepend_ipa=True,
                               abs_pos_emb=True, no_aa_emb=True, use_bf16=False),
        data=tcfg.DataConfig(num_frames=T, crop=L),
        task=tcfg.TaskConfig(inpainting=True, design=True, no_torsion=True),
        transport=tcfg.TransportConfig(sampling_method="euler", inference_steps=2))


@pytest.fixture(scope="module")
def design(tmp_path_factory):
    root = tmp_path_factory.mktemp("design")
    data = root / "data"
    synth_data.main(["--outdir", str(data), "--peptides", "AGHK", "--num_frames", "300",
                     "--suffix", "_i100"])
    ckpt = root / "ckpt"
    ckpt.mkdir()
    cfg = _cfg()
    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(1), scale=0.05)
    write_reference_checkpoint(str(ckpt / "model.ckpt"), model.state_dict(), cfg)
    (ckpt / "config.json").write_text(cfg.to_json())
    args = ["--torch_ckpt", str(ckpt / "model.ckpt"), "--data_dir", str(data),
            "--split", str(data / "split.csv"), "--suffix", "_i100", "--num_frames", str(T),
            "--num_batches", "1", "--batch_size", "2", "--seed", str(SEED)]
    return root, data, args


def test_design_inference_samples_jax_picked_windows(design):
    root, data, args = design
    design_inference.main(args + ["--out_dir", str(root / "out"), "--device", "cpu"])
    meta = json.loads((root / "out" / "AGHK_metadata.json").read_text())
    assert len(meta) == 2

    aatype = str_sequence_to_aatype("AGHK")
    jmeta = jmsm.build_msm_metadata(str(data / "AGHK_i100.npy"), aatype, str(root / "j.pkl"))
    start, end = jmsm.pick_flux_states(jmeta["cmsm"], "max")
    discrete = jmeta["msm"].metastable_assignments[jmeta["ref_kmeans"]]
    starts = np.where((discrete == start)[:-T] * (discrete == end)[T:])[0]
    assert len(starts)
    np.testing.assert_array_equal(
        design_inference.window_starts(discrete, start, end, T, len(discrete), False), starts)
    rng = np.random.default_rng(SEED)
    want = [int(rng.choice(starts)) for _ in range(2)]
    assert [m["start_idx"] for m in meta] == want
    assert [m["end_idx"] for m in meta] == [s + T for s in want]
    assert all((m["start_state"], m["end_state"]) == (start, end) for m in meta)
    for m in meta:
        models = from_pdb_models(m["path"])
        assert len(models) == T and all(np.isfinite(xyz).all() for _, xyz in models)
        aa = np.asarray(m["aa_out"])
        assert aa.shape == (T, L) and aa.min() >= 0 and aa.max() < 20


def test_analyze_design_prints_recovery(design, capsys):
    root, _, args = design
    out = root / "out"
    if not (out / "AGHK_metadata.json").exists():
        design_inference.main(args + ["--out_dir", str(out), "--device", "cpu"])
    capsys.readouterr()
    analyze_design.main(["--pdbdir", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("AGHK ") and "design_recovery" in lines[0]
    assert lines[-1].startswith("MEAN ") and "design_recovery" in lines[-1]
    meta = json.loads((out / "AGHK_metadata.json").read_text())
    preds = np.array([np.asarray(m["aa_out"])[0] for m in meta])
    rec = sequence_recovery(preds, str_sequence_to_aatype("AGHK"))
    assert f"'design_recovery': {round(rec['design_recovery'], 4)}" in lines[-1]


def test_sequence_recovery_matches_jax():
    rng = np.random.default_rng(3)
    true = rng.integers(0, 20, 6)
    preds = np.where(rng.random((40, 6)) < 0.4, true, rng.integers(0, 20, (40, 6)))
    assert sequence_recovery(preds, true) == j_sequence_recovery(preds, true)


def test_design_inference_refuses_a_missing_card(design, monkeypatch):
    root, _, args = design
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        design_inference.main(args + ["--out_dir", str(root / "refused")])  # --device cuda
    assert not (root / "refused").exists()
