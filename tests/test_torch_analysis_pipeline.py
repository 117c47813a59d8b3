"""The port's trajectory analyses on the CPU against the JAX package's:
``analysis/metrics`` (``acovf``, ``torsion_jsd``, ``decorrelation``,
``tica_jsd``), ``analysis/pipeline.analyze_sim``, the task metrics
(``analyze_tps_ensemble``, ``analyze_tps_replica_sweep``,
``analyze_upsampling``) and the three CLIs ``analyze_sim``, ``analyze_tps``,
``analyze_upsampling`` on PDBs the port wrote. Synthetic "AGHK"
trajectories as ``tests/test_analysis.py`` and
``tests/test_atlas_and_tps_metrics.py`` build them; each package runs its
own pipeline end to end (its features, TICA, k-means, MSMs).

Tolerances: the metrics on the same arrays 1e-10; downstream of the
features, which the two packages compute in f32 and which differ in their
last bits, JSDs 1e-8 (no histogram bin flips), TICA-derived and MSM arrays
rtol 1e-5 / atol 1e-8, metastable assignments and state probabilities
equal, the decorrelation curves (f16, as the reference keeps them) within
one f16 spacing plus 1e-5 (the features' atol in ``test_torch_analysis.py``:
near zero the curves are differences of O(1) sums), the autocovariances
of the sin / cos features rtol 1e-5 / atol 1e-6 (the features' f32 error,
carried into means of O(1) products).
"""
import json
import pickle
import shutil

import numpy as np
import pytest

from mdgen_finetune_tpu import analysis as ja
from mdgen_finetune_tpu.cli import analyze_sim as j_asim
from mdgen_finetune_tpu.cli import analyze_tps as j_atps
from mdgen_finetune_tpu.cli import analyze_upsampling as j_aups
from mdgen_finetune_tpu.cli import msm_common as jmsm
from mdgen_finetune_tpu.geometry.tables import str_sequence_to_aatype
from mdgen_finetune_tpu_torch import analysis as ta
from mdgen_finetune_tpu_torch.cli import analyze_sim as t_asim
from mdgen_finetune_tpu_torch.cli import analyze_tps as t_atps
from mdgen_finetune_tpu_torch.cli import analyze_upsampling as t_aups
from mdgen_finetune_tpu_torch.cli import msm_common as tmsm
from mdgen_finetune_tpu_torch.data.synthetic import synthesize_trajectory
from mdgen_finetune_tpu_torch.geometry.protein import atom14_to_pdb

SEQ = "AGHK"
AAT = str_sequence_to_aatype(SEQ)


def traj(frames, seed):
    return synthesize_trajectory(SEQ, frames, seed=seed).astype(np.float32)


def same(got, ref, path="", decor=False):
    """``got`` equals ``ref`` key by key within the module's tolerances."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), (path, set(got) ^ set(ref))
        for k in ref:
            same(got[k], ref[k], f"{path}/{k}", decor or "decorrelation" in str(k))
    elif isinstance(ref, (str, list)):
        assert got == ref, path
    else:
        g, r = np.asarray(got), np.asarray(ref)
        assert g.shape == r.shape, path
        if decor:  # f16 curves: one f16 spacing, and the features' atol 1e-5 near 0
            step = np.spacing(np.maximum(np.abs(g), np.abs(r)).astype(np.float16))
            assert (np.abs(g.astype(np.float64) - r) <= step.astype(np.float64) + 1e-5).all(), \
                path
        elif g.dtype.kind in "iub" or "metastable" in path:
            np.testing.assert_array_equal(g, r, err_msg=path)
        elif "JSD" in path or "/gen_" in path or "_rep_" in path:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-8, err_msg=path)
        elif "autocorr" in path:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6, err_msg=path)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-8, err_msg=path)


def test_metrics_match_jax():
    g = np.random.default_rng(0)
    x = np.cumsum(g.normal(size=700)) * 0.1
    for kw in ({}, {"adjusted": False}, {"demean": True}, {"nlag": 10_000}):
        kw = {"nlag": 50, **kw}
        np.testing.assert_allclose(ta.acovf(x, **kw), ja.acovf(x, **kw), rtol=1e-10, atol=1e-12)
    labels = ["PSI A 1", "PHI B 2", "PSI B 2", "PHI C 3", "PSI C 3"]
    ref = np.angle(np.exp(1j * np.cumsum(g.normal(size=(800, 5)) * 0.3, axis=0)))
    gen = np.angle(np.exp(1j * np.cumsum(g.normal(size=(500, 5)) * 0.4, axis=0)))
    got, want = ta.torsion_jsd(ref, gen, labels), ja.torsion_jsd(ref, gen, labels)
    assert list(got) == list(want) and "PHI B 2|PSI B 2" in got and "PHI C 3|PSI C 3" in got
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-10, atol=0)
    for lab, v in ja.decorrelation(gen, labels, nlag=100).items():
        d = ta.decorrelation(gen, labels, nlag=100)[lab]
        assert d.dtype == np.float16 and np.array_equal(d, v)
    tic_r, tic_g = g.normal(size=(800, 3)), g.normal(size=(500, 3)) * 1.3 + 0.2
    got, want = ta.tica_jsd(tic_r, tic_g), ja.tica_jsd(tic_r, tic_g)
    assert list(got) == ["TICA-0", "TICA-0,1"] == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), rtol=1e-10, atol=0)


@pytest.mark.parametrize("frames", [(2000, 600), (600, 400)], ids=["msm", "msm_error"])
def test_analyze_sim_matches_jax(frames):
    """At 2,000 reference frames every MSM statistic is fitted; at 600 the
    reference MSM over 100 clusters fails in both packages and the failure
    is recorded as ``msm_error``."""
    ref, gen = traj(frames[0], 0), traj(frames[1], 1)
    got = ta.analyze_sim(gen, ref, AAT, tica_lag=50, msm_lag=20)
    want = ja.analyze_sim(gen, ref, AAT, tica_lag=50, msm_lag=20)
    assert ("msm_error" in want) == (frames[0] == 600)
    same(got, want)
    if "msm_transition_matrix" in got:
        np.testing.assert_allclose(got["msm_transition_matrix"].sum(1), 1.0, atol=1e-6)
    for v in got["JSD"].values():
        assert 0 <= v <= 1
    self_ = ta.analyze_sim(ref, ref, AAT, tica_lag=50, no_msm=True, no_decorr=True)
    assert max(self_["JSD"].values()) < 1e-6 and set(self_) == {"features", "JSD"}


@pytest.fixture(scope="module")
def tps_meta(tmp_path_factory):
    d = tmp_path_factory.mktemp("tps")
    md = traj(800, 0)
    path = str(d / f"{SEQ}.npy")
    np.save(path, md)
    meta = {}
    for name, mod in (("torch", tmsm), ("jax", jmsm)):
        meta[name] = mod.build_msm_metadata(path, AAT, str(d / f"{name}_meta.pkl"), tica_lag=50,
                                            msm_lag=20, n_meta=4)
    start, end = tmsm.pick_flux_states(meta["torch"]["cmsm"], "min")
    assert (start, end) == jmsm.pick_flux_states(meta["jax"]["cmsm"], "min")
    return dict(md=md, meta=meta, start=start, end=end, dir=d)


def test_tps_metrics_match_jax(tps_meta):
    s = tps_meta
    gen = [s["md"][i: i + 60] for i in range(0, 300, 100)]
    out = {}
    for name, pkg in (("torch", ta), ("jax", ja)):
        m = s["meta"][name]
        ens = pkg.analyze_tps_ensemble(gen, AAT, m, s["start"], s["end"], stride=10,
                                       n_ref_samples=50)
        sweep = pkg.analyze_tps_replica_sweep(s["md"], AAT, m, s["start"], s["end"],
                                              ens["ref_stateprobs"], rep_fracs=(1.0, 0.05),
                                              rep_names=("100ns", "5ns"), msm_lag=20,
                                              n_samples=50)
        frozen = pkg.analyze_tps_replica_sweep(np.repeat(s["md"][:1], 200, axis=0), AAT, m,
                                               s["start"], s["end"], np.full(4, 0.25),
                                               rep_fracs=(1.0,), rep_names=("100ns",),
                                               msm_lag=20, n_samples=50)
        out[name] = {"ens": ens, "sweep": sweep, "frozen": frozen}
    same(out["torch"], out["jax"])
    t = out["torch"]
    assert 0 <= t["ens"]["gen_valid_rate"] <= 1 and abs(t["ens"]["gen_stateprobs"].sum() - 1) < 1e-9
    assert t["sweep"]["100ns_rep_valid_rate"] > 0 and t["sweep"]["100ns_rep_JSD"] < 1
    assert t["frozen"] == {"100ns_rep_prob": 0.0, "100ns_rep_valid_prob": 0.0,
                           "100ns_rep_valid_rate": 0.0, "100ns_rep_JSD": 1.0}


def test_upsampling_matches_jax():
    ref, gen = traj(1000, 0), traj(200, 2)
    got = ta.analyze_upsampling(gen, ref, AAT, subsample=10)
    same(got, ja.analyze_upsampling(gen, ref, AAT, subsample=10))
    assert len(got["subsample_autocorr"]["PSI ALA 1"]) == 100


def test_analysis_clis_match_jax(tps_meta, tmp_path, capsys):
    """The three CLIs of both packages on PDBs the port wrote
    (``geometry.protein.atom14_to_pdb``); each package in a directory of its
    own, since the CLIs write beside their inputs."""
    s = tps_meta
    mddir, repdir = tmp_path / "md", tmp_path / "replica"
    mddir.mkdir()
    repdir.mkdir()
    np.save(mddir / f"{SEQ}_i100.npy", traj(1500, 0))
    np.save(repdir / f"{SEQ}.npy", s["md"])
    dirs = {n: tmp_path / n for n in ("torch", "jax")}
    for n, d in dirs.items():
        (d / "sim").mkdir(parents=True)
        atom14_to_pdb(traj(300, 3), AAT, str(d / "sim" / f"{SEQ}.pdb"))
        (d / "tps").mkdir()
        shutil.copy(s["dir"] / f"{n}_meta.pkl", d / "tps" / f"{SEQ}_metadata.pkl")
        entries = []
        for i, start in enumerate((0, 150)):
            path = str(d / "tps" / f"{SEQ}_{i}.pdb")
            atom14_to_pdb(s["md"][start: start + 100], AAT, path)
            entries.append({"path": path, "start_state": s["start"], "end_state": s["end"]})
        (d / "tps" / f"{SEQ}_metadata.json").write_text(json.dumps(entries))
    got = {}
    for n, (asim, atps, aups) in (("torch", (t_asim, t_atps, t_aups)),
                                  ("jax", (j_asim, j_atps, j_aups))):
        d = dirs[n]
        asim.main(["--mddir", str(mddir), "--pdbdir", str(d / "sim"), "--suffix", "_i100",
                   "--tica_lag", "100", "--save"])
        aups.main(["--mddir", str(mddir), "--pdbdir", str(d / "sim"), "--suffix", "_i100",
                   "--subsample", "10"])
        atps.main(["--pdbdir", str(d / "tps"), "--outdir", str(d / "tps_out"), "--repdir",
                   str(repdir), "--msm_lag", "20", "--save", "--pdb_id", SEQ])
        got[n] = {}
        for key, path in (("sim", d / "sim" / "out.pkl"),
                          ("ups", d / "sim" / f"{SEQ}_autocorr.pkl"),
                          ("tps", d / "tps_out" / "out.pkl")):
            with open(path, "rb") as f:
                got[n][key] = pickle.load(f)
    assert "2ns_rep_JSD" in got["torch"]["tps"][SEQ]  # the replica sweep ran
    same(got["torch"], got["jax"])
    printed = capsys.readouterr().out.splitlines()
    assert sum(ln.startswith(SEQ) for ln in printed) == 6
