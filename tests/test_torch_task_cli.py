"""The port's transition-path and upsampling CLIs on the CPU.

- ``tps_inference --torch_ckpt`` writes 2 paths of a 300-frame synthetic
  "AGHK" trajectory; its start and end frames are those that the JAX
  package's ``build_msm_metadata`` + ``pick_flux_states`` and
  ``np.random.default_rng(seed)`` pick; each path's last frame is
  conditioned on the end structure.
- ``upsampling_inference`` (a ``Trainer`` checkpoint and a released-format
  ``.ckpt``): the coarse featurization and ``split_windows`` against the JAX
  package's; the stitched PDB has windows x num_frames models.
- Both CLIs raise without a card unless ``--device cpu`` is given.

Sizes: 1 layer, C = 32, 4 heads, a 2-head IPA of widths (8, 4, 4), L = 4,
T = 8, 2 Euler steps, f32. Tolerance: coarse frames and torsions 1e-4.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.cli import msm_common as jmsm
from mdgen_finetune_tpu.cli.upsampling_inference import split_windows as j_split_windows
from mdgen_finetune_tpu.geometry import frames as JG
from mdgen_finetune_tpu_torch import config as tcfg
from mdgen_finetune_tpu_torch.cli import synth_data, tps_inference, upsampling_inference
from mdgen_finetune_tpu_torch.geometry.protein import from_pdb_models, from_pdb_string
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch.models.denoiser import LatentMDGen
from mdgen_finetune_tpu_torch.tasks import prep_batch
from mdgen_finetune_tpu_torch.training import Trainer
from mdgen_finetune_tpu_torch.utils.torch_compat import write_reference_checkpoint
from mdgen_finetune_tpu_torch.utils.weights import randomize_

T, L, SEED = 8, 4, 137


def _cfg(**task):
    return tcfg.MDGenConfig(
        model=tcfg.ModelConfig(num_layers=1, embed_dim=32, mha_heads=4, ipa_heads=2,
                               ipa_head_dim=8, ipa_qk=4, ipa_v=4, prepend_ipa=True,
                               abs_pos_emb=True, use_bf16=False),
        data=tcfg.DataConfig(num_frames=T, crop=L), task=tcfg.TaskConfig(**task),
        transport=tcfg.TransportConfig(sampling_method="euler", inference_steps=2))


def _reference_ckpt(d, cfg, seed):
    d.mkdir(parents=True, exist_ok=True)
    model = randomize_(LatentMDGen(cfg), torch.Generator().manual_seed(seed), scale=0.05)
    write_reference_checkpoint(str(d / "model.ckpt"), model.state_dict(), cfg)
    (d / "config.json").write_text(cfg.to_json())
    return str(d / "model.ckpt")


@pytest.fixture(scope="module")
def tps(tmp_path_factory):
    root = tmp_path_factory.mktemp("tps")
    data = root / "data"
    synth_data.main(["--outdir", str(data), "--peptides", "AGHK", "--num_frames", "300",
                     "--suffix", "_i100"])
    ckpt = _reference_ckpt(root / "ckpt", _cfg(tps_condition=True), seed=1)
    args = ["--torch_ckpt", ckpt, "--data_dir", str(data), "--split", str(data / "split.csv"),
            "--suffix", "_i100", "--out_dir", str(root / "out"), "--num_batches", "1",
            "--batch_size", "2", "--seed", str(SEED)]
    return root, data, args


def test_tps_inference_writes_paths_between_jax_picked_frames(tps):
    root, data, args = tps
    tps_inference.main(args + ["--device", "cpu"])
    meta = json.loads((root / "out" / "AGHK_metadata.json").read_text())
    assert len(meta) == 2
    for m in meta:
        models = from_pdb_models(m["path"])
        assert len(models) == T and all(np.isfinite(xyz).all() for _, xyz in models)

    aatype = str_sequence_to_aatype("AGHK")
    jmeta = jmsm.build_msm_metadata(str(data / "AGHK_i100.npy"), aatype, str(root / "j.pkl"))
    start, end = jmsm.pick_flux_states(jmeta["cmsm"], "min")
    discrete = jmeta["msm"].metastable_assignments[jmeta["ref_kmeans"]]
    starts, ends = np.where(discrete == start)[0], np.where(discrete == end)[0]
    rng = np.random.default_rng(SEED)
    want = [(int(rng.choice(starts)), int(rng.choice(ends))) for _ in range(2)]
    assert [(m["start_idx"], m["end_idx"]) for m in meta] == want
    assert all((m["start_state"], m["end_state"]) == (start, end) for m in meta)

    # the window: frames 0..T-2 the start structure, T-1 the end one, both conditioned
    arr = np.load(data / "AGHK_i100.npy")
    si, ei = want[0]
    batch = tps_inference.make_endpoint_batch(arr, aatype, np.ones(L, np.float32), si, ei, T)
    kw = prep_batch(_cfg(tps_condition=True), batch)["model_kwargs"]
    assert kw["x_cond_mask"][0, [0, -1]].tolist() == [[1] * L] * 2
    assert int(kw["x_cond_mask"][0, 1:-1].sum()) == 0
    np.testing.assert_allclose(kw["end_frames"].trans[0].numpy(),
                               batch["trans"][0, -1].numpy(), atol=0)


@pytest.fixture(scope="module")
def coarse(tmp_path_factory):
    root = tmp_path_factory.mktemp("ups")
    data = root / "data"
    synth_data.main(["--outdir", str(data), "--peptides", "AAGG", "--num_frames", "6",
                     "--suffix", "_i100"])
    return root, data


def test_split_windows_match_jax(coarse):
    _, data = coarse
    arr = np.load(data / "AAGG_i100.npy").astype(np.float32)
    aatype = str_sequence_to_aatype("AAGG")
    item = upsampling_inference.coarse_item(arr, aatype)
    frames = JG.atom14_to_frames(jnp.asarray(arr))
    aat = jnp.broadcast_to(jnp.asarray(aatype), arr.shape[:2])
    tors, tmask = JG.atom37_to_torsions(JG.atom14_to_atom37(jnp.asarray(arr), aat), aat)
    np.testing.assert_allclose(item["trans"], np.asarray(frames.trans), atol=1e-4)
    np.testing.assert_allclose(item["rots"], np.asarray(frames.rot), atol=1e-4)
    np.testing.assert_allclose(item["torsions"], np.asarray(tors), atol=1e-4)
    np.testing.assert_array_equal(item["torsion_mask"], np.asarray(tmask)[0])
    got, want = (upsampling_inference.split_windows(item, T, 4), j_split_windows(item, T, 4))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("kind", ["ckpt", "torch_ckpt"])
def test_upsampling_inference_writes_every_window(coarse, kind, capsys):
    root, data = coarse
    cfg = _cfg(sim_condition=True, cond_interval=4)
    if kind == "ckpt":
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state(0)
        randomize_(trainer.model, torch.Generator().manual_seed(2), scale=0.05)
        trainer.save_checkpoint(state, str(root / "trainer_ckpt"))
        load = ["--ckpt", str(root / "trainer_ckpt")]
    else:
        load = ["--torch_ckpt", _reference_ckpt(root / "ref", cfg, seed=3)]
    out = root / f"out_{kind}"
    capsys.readouterr()
    upsampling_inference.main(load + ["--data_dir", str(data), "--split", str(data / "split.csv"),
                                      "--out_dir", str(out), "--device", "cpu"])
    assert "upsampled 6 coarse -> 24 frames" in capsys.readouterr().out
    text = (out / "AAGG.pdb").read_text()
    pos = np.stack([from_pdb_string(c).atom_positions for c in text.split("ENDMDL") if "ATOM" in c])
    assert pos.shape[:2] == (3 * T, L) and np.isfinite(pos).all()
    n_ca = np.linalg.norm(pos[:, :, 0] - pos[:, :, 1], axis=-1)
    assert np.abs(n_ca - 1.458).max() < 1e-2


@pytest.mark.parametrize("cli", ["tps", "upsampling"])
def test_task_clis_refuse_a_missing_card(tps, coarse, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "tps":
        root, _, args = tps
        run, argv = tps_inference.main, list(args)
        argv[argv.index("--out_dir") + 1] = str(root / "refused")
    else:
        root, data = coarse
        run = upsampling_inference.main
        argv = ["--torch_ckpt", _reference_ckpt(root / "ref_refused", _cfg(sim_condition=True,
                                                                           cond_interval=4), 4),
                "--data_dir", str(data), "--split", str(data / "split.csv"),
                "--out_dir", str(root / "refused")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(argv)  # --device defaults to cuda
    assert not (root / "refused").exists()
