"""PyTorch port, the host-side modules held against the JAX package on the
CPU:

- the ``Rigid`` helpers (``quat_multiply``, ``Rigid.identity``,
  ``from_quat_trans``, ``to_tensor_4x4``, ``scale_translation``) against
  JAX's, in f32;
- ``cli/run_peptide_sim.build_extended_peptide`` against JAX's, and its
  ``main`` without OpenMM (a ``SystemExit`` naming ``synth_data``);
- ``native.NativeLoader`` (the port's copy of ``loader.cpp``, built under
  ``mdgen_finetune_tpu_torch/_build/``) against JAX's ``NativeLoader`` on a
  synthetic set: one worker thread, the same seed, the same batches bit
  for bit, padded and cropped; ``ImportError`` where g++ is missing;
- ``cli/download_data`` on a local ``file://`` mirror (unpack, skip when
  present, ``--dry_run`` prints the plan and fetches nothing); no network;
- ``cli/prep_sims`` on ``.npy`` inputs: existing outputs "exists", the
  others skipped without mdtraj, as in JAX.

Tolerances: the rigid helpers and the peptide 1e-5 (f32 round-off between
the two packages' reconstructions); the loader's batches exact.
"""
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdgen_finetune_tpu.cli import run_peptide_sim as j_run
from mdgen_finetune_tpu.geometry import rigid as jrigid
from mdgen_finetune_tpu_torch.cli import download_data, prep_sims
from mdgen_finetune_tpu_torch.cli import run_peptide_sim as t_run
from mdgen_finetune_tpu_torch.data.synthetic import make_synthetic_dataset
from mdgen_finetune_tpu_torch.geometry import rigid as trigid
from mdgen_finetune_tpu_torch.geometry.tables import str_sequence_to_aatype


def test_rigid_helpers_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = (rng.normal(size=(3, 5, 4)).astype(np.float32) for _ in range(2))
    tr = rng.normal(size=(3, 5, 3)).astype(np.float32) * 5
    np.testing.assert_allclose(trigid.quat_multiply(torch.from_numpy(q1), torch.from_numpy(q2)),
                               np.asarray(jrigid.quat_multiply(q1, q2)), rtol=1e-5, atol=1e-5)
    ti, ji = trigid.Rigid.identity((2, 3)), jrigid.Rigid.identity((2, 3))
    np.testing.assert_array_equal(ti.rot.numpy(), np.asarray(ji.rot))
    np.testing.assert_array_equal(ti.trans.numpy(), np.asarray(ji.trans))
    for norm in (True, False):
        t = trigid.Rigid.from_quat_trans(torch.from_numpy(q1), torch.from_numpy(tr), norm)
        j = jrigid.Rigid.from_quat_trans(jnp.asarray(q1), jnp.asarray(tr), norm)
        np.testing.assert_allclose(t.rot.numpy(), np.asarray(j.rot), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(t.trans.numpy(), np.asarray(j.trans))
        np.testing.assert_allclose(t.to_tensor_4x4().numpy(), np.asarray(j.to_tensor_4x4()),
                                   rtol=1e-5, atol=1e-5)
        ts, js = t.scale_translation(0.1), j.scale_translation(0.1)
        np.testing.assert_array_equal(ts.trans.numpy(), np.asarray(js.trans))
        np.testing.assert_array_equal(ts.rot.numpy(), t.rot.numpy())
    back = trigid.Rigid.from_tensor_4x4(t.to_tensor_4x4())
    assert torch.equal(back.rot, t.rot) and torch.equal(back.trans, t.trans)


def test_extended_peptide_matches_jax_and_md_needs_openmm(tmp_path):
    for seq in ("AGHK", "WYFP"):
        got = t_run.build_extended_peptide(seq)
        assert got.shape == (4, 14, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, j_run.build_extended_peptide(seq), rtol=1e-5, atol=1e-5)
    split = tmp_path / "split.csv"
    split.write_text("name,seqres\nAGHK,AGHK\n")
    try:
        import openmm  # noqa: F401
    except ImportError:
        with pytest.raises(SystemExit, match="synth_data"):
            t_run.main(["--splits", str(split), "--outdir", str(tmp_path / "md")])
        assert not (tmp_path / "md").exists()


@pytest.fixture(scope="module")
def npy_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native"))
    make_synthetic_dataset(d, ["AGHK", "LMNA"], num_frames=50)
    return d, [(os.path.join(d, f"{s}.npy"), str_sequence_to_aatype(s)) for s in ("AGHK", "LMNA")]


@pytest.mark.parametrize("crop", [4, 6, 2])
def test_native_loader_matches_jax(npy_set, crop):
    """The port's loader and JAX's, one worker, the same seed: the same
    batches (crop 4 = L, 6 pads, 2 crops a window of residues)."""
    from mdgen_finetune_tpu.native import NativeLoader as JLoader
    from mdgen_finetune_tpu_torch.native import NativeLoader as TLoader
    from mdgen_finetune_tpu_torch.native import loader as tl

    _, files = npy_set
    kw = dict(batch_size=3, num_frames=8, crop=crop, frame_interval=2, seed=5, n_threads=1)
    tld, jld = TLoader(files, **kw), JLoader(files, **kw)
    assert tl._SO.endswith(os.path.join("mdgen_finetune_tpu_torch", "_build", "_loader.so"))
    try:
        for _ in range(4):
            a, b = next(tld), next(jld)
            assert set(a) == set(b) == {"atom14", "seqres", "mask"}
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a["atom14"].shape == (3, 8, crop, 14, 3)
            assert (a["mask"][:, :min(crop, 4)] == 1).all() and (a["mask"][:, 4:] == 0).all()
    finally:
        tld.close()
        jld.close()


def test_native_loader_needs_gpp(monkeypatch, tmp_path):
    from mdgen_finetune_tpu_torch.native import loader as tl

    monkeypatch.setattr(tl, "_SO", str(tmp_path / "_build" / "_loader.so"))
    monkeypatch.setattr(tl.shutil, "which", lambda name: None)
    with pytest.raises(ImportError, match="g\\+\\+"):
        tl.build_native_library()
    assert not (tmp_path / "_build").exists()


@pytest.fixture
def mirror(tmp_path):
    """A local file:// mirror with two ATLAS-like entries and a split CSV."""
    root = tmp_path / "mirror"
    names = ["1abc_A", "2xyz_B"]
    for name in names:
        d = root / name
        d.mkdir(parents=True)
        with zipfile.ZipFile(d / f"{name}_protein.zip", "w") as zf:
            zf.writestr(f"{name}.pdb", "ATOM fake\n")
            zf.writestr(f"{name}_R1.xtc", b"\x00\x01")
    split = tmp_path / "split.csv"
    split.write_text("name,seqres\n" + "".join(f"{n},AAAA\n" for n in names))
    return root.as_uri(), str(split), names


def test_download_data_from_a_local_mirror_and_dry_run(mirror, tmp_path, capsys):
    base, split, names = mirror
    assert download_data.read_split_names(split) == names
    assert download_data.entry_url("http://x/ATLAS/", "1k5n_A") == \
        "http://x/ATLAS/1k5n_A/1k5n_A_protein.zip"
    out = tmp_path / "out"
    got = download_data.fetch_entry(base, names[0], str(out))
    assert got and os.path.isfile(os.path.join(got, f"{names[0]}.pdb"))
    assert download_data.fetch_entry(base, names[0], str(out)) is None  # present: skipped
    assert download_data.main(["--split", split, "--outdir", str(out), "--base_url", base]) == 0
    for name in names:
        assert (out / name / f"{name}_R1.xtc").read_bytes() == b"\x00\x01"
    assert sorted(os.listdir(out)) == sorted(names)  # no temporary archive left
    err = capsys.readouterr().err
    assert "downloaded 1, skipped 1" in err
    assert download_data.main(["--split", split, "--outdir", str(tmp_path / "dry"),
                               "--dry_run"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [download_data.entry_url(download_data.DEFAULT_BASE, n) for n in names]
    assert not (tmp_path / "dry").exists()
    assert download_data.main(["--split", split, "--outdir", str(tmp_path / "bad"),
                               "--base_url", base + "/missing"]) == 1


def test_prep_sims_on_npy_inputs(tmp_path, capsys):
    d = tmp_path / "data"
    make_synthetic_dataset(str(d), ["AGHK"], num_frames=10, suffix="_i100")
    split = tmp_path / "split.csv"
    split.write_text("name,seqres\nAGHK,AGHK\nLMNA,LMNA\n")
    before = np.load(d / "AGHK_i100.npy")
    prep_sims.main(["--splits", str(split), "--sim_dir", str(tmp_path / "sims"), "--outdir",
                    str(d), "--suffix", "_i100"])
    out = dict(line.split(" ", 1) for line in capsys.readouterr().out.strip().splitlines())
    assert out["AGHK"] == "exists"
    np.testing.assert_array_equal(np.load(d / "AGHK_i100.npy"), before)
    try:
        import mdtraj  # noqa: F401
    except ImportError:
        assert out["LMNA"].startswith("skipped (mdtraj not installed")
        assert not (d / "LMNA_i100.npy").exists()
